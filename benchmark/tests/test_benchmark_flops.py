"""The analytic counts against sums by hand."""

import pytest

from benchmark import flops


def test_resnet26_at_300px():
    cfg = {"tile_px": 300, "widths": [20, 40, 60, 80],
           "blocks": [3, 3, 3, 3], "L": 80}
    seg = flops.segment_flops(300)
    # stem: 150 x 150 outputs of a 7x7x3 -> 20 conv
    assert seg["stem"] == 2 * 150 * 150 * 49 * 3 * 20
    # stage 1 at 75 x 75, six 3x3 20 -> 20 convs
    assert seg["stage1"] == 6 * 2 * 75 * 75 * 9 * 20 * 20
    # stage 2: 38 x 38; 20 -> 40, then five 40 -> 40, and the 1x1 shortcut
    assert seg["stage2"] == 2 * 38 * 38 * (9 * 20 * 40 + 5 * 9 * 40 * 40
                                           + 20 * 40)
    total = flops.resnet26_tile_flops(cfg)
    assert total == pytest.approx(0.8078448e9)
    assert flops.resnet26_train_tile_flops(cfg) == pytest.approx(
        3 * total - seg["stem"])


def test_critic_blocks_at_128px():
    cfg = {"width_mult": 1.0, "step": 5, "disc_cutoff": 6}
    blocks = dict(flops.critic_block_flops(cfg))
    assert sorted(blocks) == [0, 1, 2, 3, 4, 5]
    # 128 px: from_rgb 3 -> 128, 5x5 128 -> 256, the blur, then the fused
    # 6x6 stride-2 256 -> 256 to 64 px
    s = 128
    assert blocks[5] == (2 * s * s * 3 * 128 + 2 * s * s * 25 * 128 * 256
                         + 2 * s * s * 9 * 256
                         + 2 * 64 * 64 * 36 * 256 * 256)
    # 64 px: 3x3 256 -> 512, the blur, 3x3 512 -> 512 at 64 px
    assert blocks[4] == (2 * 64 * 64 * 9 * 256 * 512 + 2 * 64 * 64 * 9 * 512
                         + 2 * 64 * 64 * 9 * 512 * 512)
    # 4 px: 3x3 513 -> 512 at 4 px, then the 4x4 conv to one pixel
    assert blocks[0] == 2 * 16 * 9 * 513 * 512 + 2 * 16 * 512 * 512
    assert flops.critic_tile_flops(cfg) == pytest.approx(88.0678e9, rel=1e-5)


def test_pool_bytes_per_tile():
    # K = 3, O = 1: 44 B a tile forward, 48 B backward (PERF.md's kernel
    # table)
    f0, b0 = flops.pool_fwd_cost(0, 3, 1)
    f1, b1 = flops.pool_fwd_cost(1000, 3, 1)
    assert (b1 - b0) / 1000 == 44
    f0, b0 = flops.pool_bwd_cost(0, 3, 1)
    f1, b1 = flops.pool_bwd_cost(1000, 3, 1)
    assert (b1 - b0) / 1000 == 48
