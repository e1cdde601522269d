"""Programs over a model: so far the inference half of the dense family's
(``DensePrograms``: the whole-scene class map, whole or in row bands)."""
