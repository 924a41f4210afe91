"""matcher_device_ms: device ms issued under the program's ``match`` and
``extract`` spans (each with what runs inside it), per dispatch completed in
the traced window (``slambench/spans.py::by_program_span``,
``run.trace.program``). Silent without the program's spans."""


def read(run):
    prog = getattr(run.trace, "program", None)
    if prog is None or run.steps == 0:
        return None
    s = prog.device_incl_s.get("match", 0.0) + prog.device_incl_s.get("extract", 0.0)
    return s * 1e3 / run.steps if s > 0 else None
