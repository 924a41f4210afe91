"""Device-side operations: the fused per-frame step (frontend_step), f32
precision control (precision) and the hand-written CUDA kernels (cuda/).
Nothing is imported eagerly here: the models import ops.cuda, and
ops.frontend_step imports the models."""
