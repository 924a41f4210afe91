"""issue_idle_pct: the card's idle time under the program's ``step`` spans
and their descendants (the host issuing a step's work while the card has
none), in % of the traced window (``slambench/spans.py::by_program_span``,
``run.trace.program``). Silent without the program's spans."""


def read(run):
    prog = getattr(run.trace, "program", None)
    if prog is None or not prog.device_incl_s.get("step"):
        return None
    return 100.0 * prog.idle_incl_s.get("step", 0.0) / prog.window_s
