"""prepare_idle_pct: the card's idle time under the program's
``upload.prepare`` spans (nothing open inside them), in % of the traced
window (``slambench/spans.py::by_program_span``, ``run.trace.program``).
Silent without the program's spans."""


def read(run):
    prog = getattr(run.trace, "program", None)
    if prog is None or not prog.device_incl_s:
        return None
    return 100.0 * prog.idle_s.get("upload.prepare", 0.0) / prog.window_s
