"""Programs over a model: the patch classifiers' (``DualPrograms``) and
the dense family's (``DensePrograms``: training, eval and the whole-scene
class map, whole or in row bands); losses, optimizers, checkpoints."""
