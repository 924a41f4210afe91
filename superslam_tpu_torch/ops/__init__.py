"""Device-side operations: the fused per-frame steps (frontend_step,
rgbd_step), the pose and window solvers, the retrieval index, f32
precision control (precision) and the hand-written CUDA kernels (cuda/).

The names the JAX package's ``ops`` exports resolve on first use (PEP
562): the models import ops.cuda and ops.frontend_step imports the
models, so nothing is imported eagerly here."""

_EXPORTS = {
    "PACK_ROWS": "frontend_step",
    "fused_stereo_step": "frontend_step",
    "fused_stereo_step_multi": "frontend_step",
    "DeviceCosineIndex": "retrieval",
    "ShardedCosineIndex": "retrieval",
    "RGBD_PACK_ROWS": "rgbd_step",
    "fused_rgbd_step": "rgbd_step",
    # the JAX package's jit of pose_only_lm_impl: the function itself here
    "pose_only_lm": ("pose_solver", "pose_only_lm_impl"),
    "build_reduced_system": "window_solver",
    "solve_window": "window_solver",
    "triangulate": "window_solver",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(name)
    import importlib

    module, attr = _EXPORTS[name] if isinstance(_EXPORTS[name], tuple) else (_EXPORTS[name], name)
    return getattr(importlib.import_module(f".{module}", __name__), attr)
