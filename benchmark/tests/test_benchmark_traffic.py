"""The traffic generator: the same seed gives the same work, every seed
the same set of sizes."""

import numpy as np
import torch

from benchmark import generator
from benchmark.tests import tiny

SEED = 2 ** 31 + 77  # run seeds may pass 32 signed bits


def _take(it, n):
    return [next(it) for _ in range(n)]


def _windows(seed):
    c = tiny.cell("mil26_train_window")
    t = generator.Traffic(c["mix"], c["config"], seed, c["mix"]["pool_tiles"])
    return _take(t.windows(), 3)


def test_slides_repeat_for_a_seed_and_keep_their_sizes():
    cell = tiny.cell("mil26_stream_cohort")
    mix, cfg = cell["mix"], cell["config"]
    a = _take(generator.Traffic(mix, cfg, SEED, 96).slides(), 20)
    b = _take(generator.Traffic(mix, cfg, SEED, 96).slides(), 20)
    c = _take(generator.Traffic(mix, cfg, SEED + 1, 96).slides(), 20)
    assert a == b and a != c
    sizes = generator.slide_sizes(mix["sizes"], cfg)
    assert sorted(t for t, _ in a[:8]) == sorted(sizes)
    assert sorted(t for t, _ in c[:8]) == sorted(sizes)
    assert all(0 <= o <= 96 - t for t, o in a + c)


def test_training_windows_repeat_for_a_seed():
    a, b, c = _windows(SEED), _windows(SEED), _windows(SEED + 1)
    for wa, wb in zip(a, b):
        for (oa, na, la), (ob, nb, lb) in zip(wa, wb):
            assert oa == ob and la == lb
            assert all(torch.equal(na[k], nb[k]) for k in na)
    assert not torch.equal(a[0][0][1]["scores"], c[0][0][1]["scores"])
    noise = a[0][0][1]
    assert noise["keep"].shape == (8, 80)  # k = int(40 * 0.2) rows
    assert int(noise["offsets"].max()) <= 6 and int(noise["offsets"].min()) >= 0


def test_pool_repeats_for_a_seed():
    dev = torch.device("cpu")
    a = generator.make_pool(20, 8, SEED, dev, block=7)
    b = generator.make_pool(20, 8, SEED, dev, block=7)
    assert a.dtype == np.uint8 and a.shape == (20, 8, 8, 3)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, generator.make_pool(20, 8, SEED + 1, dev))


def test_sizes_are_log_uniform_quantiles():
    s = generator.slide_sizes({"count": 48, "multiple": 32},
                              {"slide_tiles_min": 1024,
                               "slide_tiles_max": 8192})
    assert len(set(s)) == 48 and s == sorted(s)
    assert 1024 <= s[0] and s[-1] <= 8192
    assert all(t % 32 == 0 for t in s)
    mean = (8192 - 1024) / np.log(8192 / 1024)  # the law's mean
    assert abs(np.mean(s) - mean) / mean < 0.01
