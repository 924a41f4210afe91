"""prepare_ms: host ms in the program's ``upload.prepare`` spans (the
caller's fill of the pinned slot: ``parallel/multi_tracker.py::_prepare``,
``FusedRgbdPipeline._prepare_np``), summed over a dispatch's uploads, the
mean over the window's dispatches: its ``step`` spans not opened inside
another ``step`` (the device-tracked RGB-D step opens the front end's
inside its own). Silent without the program's spans
(``run.program_spans``: ``superslam_tpu_torch/utils/profiler.py``'s
recording over the traced window)."""


def read(run):
    spans = getattr(run, "program_spans", None)
    if not spans:
        return None
    steps = sum(1 for s in spans
                if s[0] == "step" and (s[3] < 0 or spans[s[3]][0] != "step"))
    if steps == 0:
        return None
    return sum(s[2] - s[1] for s in spans if s[0] == "upload.prepare") * 1e-6 / steps
