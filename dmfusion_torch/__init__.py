"""dmfusion_torch — the PyTorch and CUDA port of dmfusion.

The JAX package ``dmfusion`` stays the reference; this package is held
against it by the ``tests/test_torch_*.py`` parity tests.  It imports
torch, numpy and the standard library only — never jax, flax or anything
of ``dmfusion`` — and keeps its own copies of the framework-neutral code
(config schema and rendering).

Ported so far: the serving path of the default model, gmfnet — config,
scene, window gathers (a hand-written CUDA kernel on the card), models,
artifact export/load, scene inference and metrics; its training end to
end from ``python -m dmfusion_torch.cli`` — run slots, seeded splits,
losses, optimizers and schedules, train/eval/predict programs,
checkpoints, the train/test/color solver, xlsx reports and class-map
PNGs; and the whole-scene class map of the dense flagship, dense_fusion,
with its phase window-pool as a second hand-written CUDA kernel; dense
and gmfnet_conv training; the tri arity (tri_net with its seeded IHS
MSPAN stream); the two-stage DQTL solver; and the rest of the zoo —
resnet18, cross_net, vit, swin_transformer, swin_T_dual and ct_lstm
(with the contourlet transform, which the ``proof`` phase renders).
Every model of dmfusion's zoo trains on the card.
"""

__version__ = "0.1.0"
