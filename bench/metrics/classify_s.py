"""``classify_s``: seconds of the run's plan spent classifying the operator,
the total of the program's ``spmm.plan.classify`` spans under its
``spmm.plan`` root (``repro_torch.core.trace``).

Also the span readers' shared helpers: :func:`run_spans` and :func:`under`.
"""


def run_spans(spans=None):
    """The spans of this run: the latest ``spmm.plan`` root and every span
    that started after it (the tracer's buffer where ``spans`` is None).
    None where there is no such root, as in a program without the tracer.
    """
    if spans is None:
        try:
            from repro_torch.core import trace
        except ImportError:
            return None
        spans = trace.spans()
    roots = [s.start_ns for s in spans
             if s.name == "spmm.plan" and s.parent_id is None]
    if not roots:
        return None
    t0 = max(roots)
    return [s for s in spans if s.start_ns >= t0]


def under(spans, root: str, name: str):
    """``(roots, found)``: the spans named ``root``, and the spans named
    ``name`` that have one of them among their ancestors."""
    by_id = {s.span_id: s for s in spans}
    roots = [s for s in spans if s.name == root]
    root_ids = {s.span_id for s in roots}

    def rooted(s):
        parent = s.parent_id
        while parent is not None:
            if parent in root_ids:
                return True
            up = by_id.get(parent)
            parent = None if up is None else up.parent_id
        return False

    return roots, [s for s in spans if s.name == name and rooted(s)]


def setup_total_s(name: str, root: str, spans=None):
    """Seconds in the spans ``name`` under the run's ``root`` spans; 0.0
    where there are none, None where the run has no ``root``."""
    run = run_spans(spans)
    if run is None:
        return None
    roots, found = under(run, root, name)
    if not roots:
        return None
    return sum(s.end_ns - s.start_ns for s in found) / 1e9


def read(rec, spans=None):
    """Total seconds of ``spmm.plan.classify``."""
    return setup_total_s("spmm.plan.classify", "spmm.plan", spans)
