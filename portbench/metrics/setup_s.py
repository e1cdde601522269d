"""setup_s: seconds from process start to the first timed unit of work
(imports, the scene and weights made on the card, the model loaded, and the
warm-up of the cell's shapes), by the host clock."""


def read(run):
    return run.setup_s
