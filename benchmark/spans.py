"""What the readers of the port's own spans and counters share.

The port marks its layer boundaries with ``port.*`` spans and counts its
work with counters (``utils/profiling.annotate`` and ``count``); both
record only while a profiler records, so after a traced window the
counters hold the window's counts. A span is a ``record_function``
annotation in the same profiler session as the card's records, so the
spans and the device intervals of ``run.trace`` share one clock.

Each moment of the window with nothing on the card goes to the chain of
``port.*`` spans covering it on the main thread, outermost first; a reading
of the innermost span is the span's self time, so such readings partition
the idle time. Every reader returns None where the trace holds no
``port.*`` span, no device activity or not the counter it needs, as with a
program that has none.
"""

from deep_convolutional_neural_network_resnet_26_and_attention_network_tpu_torch.utils import profiling  # noqa: E501

PORT = "port."
STAGE = "port.stage."
STEP = ("port.bag", "port.backward", "port.adam", "port.home")
TAIL = ("port.pool", "port.home")


def port_counters():
    """The port's counters, or an empty dict where it has none."""
    read = getattr(profiling, "counters", None)
    return read() if read is not None else {}


def _pieces(spans):
    """``(start, end, chain)`` over which the covering spans stay the same,
    for spans sorted by start, outer before inner at a tie; uncovered time
    has no piece."""
    edges = []
    for i, (a, b, _) in enumerate(spans):
        edges += [(a, 1, i), (b, 0, i)]
    edges.sort()
    active, out, t = [], [], None
    for x, opens, i in edges:
        if active and x > t:
            out.append((t, x, tuple(spans[j][2] for j in active)))
        t = x
        if opens:
            active.append(i)
        else:
            active.remove(i)
    return out


def idle_by_chain(trace):
    """Seconds of the window with nothing on the card, by the chain of
    ``port.*`` spans covering them (``()`` where none does); None where the
    trace has no ``port.*`` span or no device activity."""
    spans = sorted(((a, b, n) for a, b, n in trace.host
                    if n.startswith(PORT)), key=lambda s: (s[0], -s[1]))
    if not spans or not trace.ops:
        return None
    idle, t = [], trace.t0
    for a, b in trace.busy:
        if a > t:
            idle.append((t, a))
        t = max(t, b)
    if trace.t1 > t:
        idle.append((t, trace.t1))
    pieces = _pieces(spans)
    out, j = {}, 0
    for a, b in idle:
        while j < len(pieces) and pieces[j][1] <= a:
            j += 1
        covered, k = 0.0, j
        while k < len(pieces) and pieces[k][0] < b:
            s = min(b, pieces[k][1]) - max(a, pieces[k][0])
            if s > 0:
                chain = pieces[k][2]
                out[chain] = out.get(chain, 0.0) + s * 1e-6
                covered += s
            k += 1
        out[()] = out.get((), 0.0) + (b - a - covered) * 1e-6
    return out


def _idle_percent(run, under):
    by = idle_by_chain(run.trace)
    if by is None or run.trace.window_s <= 0:
        return None
    s = sum(v for chain, v in by.items() if chain and under(chain))
    return 100.0 * s / run.trace.window_s


def stage_idle_percent(run):
    """Share of the window with the card idle and the host inside a
    ``port.stage.*`` span (its innermost)."""
    return _idle_percent(run, lambda c: c[-1].startswith(STAGE))


def step_idle_percent(run):
    """Share of the window with the card idle under a bag's forward or
    backward, the Adam step or the copy home of a window step (staging
    excepted)."""
    return _idle_percent(run, lambda c: not c[-1].startswith(STAGE)
                         and any(n in STEP for n in c))


def tail_idle_ms_per_slide(run):
    """Card-idle milliseconds of a streamed slide (``port.slide``) under its
    pool (``port.pool``) or its copies home (``port.home``), the innermost
    span, per slide streamed."""
    slides = port_counters().get("stream.slides", 0)
    by = idle_by_chain(run.trace)
    if by is None or slides <= 0:
        return None
    s = sum(v for chain, v in by.items()
            if chain and chain[0] == "port.slide" and chain[-1] in TAIL)
    return s * 1e3 / slides


def stage_fill_ms_per_ktile(run):
    """Host milliseconds inside ``port.stage.fill`` (the copy into the
    pinned buffer and the copy's enqueue) per 1000 tiles staged."""
    tiles = port_counters().get("stage.tiles", 0)
    fills = [b - a for a, b, n in run.trace.host if n == "port.stage.fill"]
    if not fills or tiles <= 0:
        return None
    return sum(fills) * 1e-3 / (tiles / 1000.0)
