"""The numbers that decide ``correct``: what the timed path produced against
the plain reference, each held to its limit (``limits/<cell>.json``).

Serving: for each slide of the sample, the gap of the probabilities; of
M, the logits, each over the size of its terms, which random weights make
cancel toward zero (the reference's ``Mscale``, down to the features:
``mterm_gap``; ``Bscale``, at the instance outputs: ``mterm_gap_b``); and
of the attention maps A (their largest over the slide's largest reference
weight, and their norm over the reference's norm); the worst slide's.
``aterm_rms_all`` is the attention maps' norm of the gap over the
reference's, over all the sampled slides together. Training: the gap of each step's window loss, over the
reference's; the gap between the program's and the reference's norms of
the first step's gradient, leaf by leaf; and the same of the parameters'
change after the reference's steps, over the leaves the reference moves;
each leaf's gap over the larger of its reference norm and the median
leaf's.
"""

import math

import numpy as np


def _max_abs(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                                - np.asarray(b, np.float64))))


def serve_numbers(pairs):
    """``pairs``: [(program outputs, reference outputs)] of the sampled
    slides, each a dict of ``probs`` [C], ``Mterm`` [K, O], ``Aterm``
    [K, T]; the reference's also of ``Mscale`` and ``Bscale`` [K, O], the
    size of M's terms."""
    out = {"prob_gap": 0.0, "mterm_gap": 0.0, "mterm_gap_b": 0.0,
           "aterm_gap": 0.0, "aterm_rms": 0.0, "aterm_rms_all": 0.0}
    gap2 = ref2 = 0.0
    for p, r in pairs:
        A, Ar = (np.asarray(p["Aterm"], np.float64),
                 np.asarray(r["Aterm"], np.float64))
        if A.shape != Ar.shape:
            return {k: math.inf for k in out}
        dM = np.abs(np.asarray(p["Mterm"], np.float64).reshape(-1)
                    - np.asarray(r["Mterm"], np.float64).reshape(-1))
        out["prob_gap"] = max(out["prob_gap"], _max_abs(p["probs"],
                                                        r["probs"]))
        for name, key in (("mterm_gap", "Mscale"), ("mterm_gap_b", "Bscale")):
            scale = np.asarray(r[key], np.float64).reshape(-1)
            out[name] = max(out[name],
                            float(np.max(dM / np.maximum(scale, 1e-30))))
        gap2 += float(np.sum((A - Ar) ** 2))
        ref2 += float(np.sum(Ar ** 2))
        out["aterm_gap"] = max(out["aterm_gap"], _max_abs(A, Ar)
                               / max(float(np.abs(Ar).max()), 1e-30))
        out["aterm_rms"] = max(out["aterm_rms"], float(
            np.linalg.norm(A - Ar) / max(np.linalg.norm(Ar), 1e-30)))
    out["aterm_rms_all"] = (gap2 / max(ref2, 1e-60)) ** 0.5
    return out


def _leaf_gaps(prog, ref, leaves):
    """Each leaf's gap, over the larger of its reference norm and the
    median leaf's."""
    med = float(np.median([ref[k] for k in leaves])) if leaves else 0.0
    return [abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30) for k in leaves]


def train_numbers(prog, ref):
    """``prog`` and ``ref``: ``losses`` [steps], ``grad`` and ``change``
    (leaf -> norm). The losses' gaps: the first step's (``loss1_gap``) and
    the worst step's (``loss_gap``); the gradient's: the worst leaf's
    (``grad_gap``) and the median leaf's (``grad_med_gap``); the change's:
    the worst leaf's and the median leaf's (``change_gap``,
    ``change_med_gap``), over the leaves the reference moves (a leaf whose
    reference gradient is under a thousandth of the median leaf's moves by
    round-off alone and is left out)."""
    n = len(ref["losses"])
    names = ("loss1_gap", "loss_gap", "grad_gap", "grad_med_gap",
             "change_gap", "change_med_gap")
    if len(prog["losses"]) < n or set(prog["grad"]) != set(ref["grad"]) \
            or not all(math.isfinite(x) for x in prog["losses"][:n]):
        return {k: math.inf for k in names}
    loss = [abs(prog["losses"][i] - ref["losses"][i])
            / max(abs(ref["losses"][i]), 1e-30) for i in range(n)]
    leaves = sorted(ref["grad"])
    med = float(np.median([ref["grad"][k] for k in leaves]))
    moved = [k for k in leaves if ref["grad"][k] >= 1e-3 * med]
    grad = _leaf_gaps(prog["grad"], ref["grad"], leaves)
    change = _leaf_gaps(prog["change"], ref["change"], moved)
    return {"loss1_gap": loss[0], "loss_gap": max(loss),
            "grad_gap": max(grad), "grad_med_gap": float(np.median(grad)),
            "change_gap": max(change, default=0.0),
            "change_med_gap": float(np.median(change)) if change else 0.0}


def verdict(numbers, limits):
    """``(correct, checks)``: every number with a limit is finite and at
    most its limit; ``checks`` maps each to ``{"value", "limit"}``. No
    limit at all is not correct."""
    checks = {}
    for name, lim in limits.items():
        v = numbers.get(name, math.nan)
        checks[name] = {"value": v, "limit": lim["limit"]}
    ok = bool(checks) and all(
        math.isfinite(c["value"]) and c["value"] <= c["limit"]
        for c in checks.values())
    return ok, checks
