from dmfusion_torch.data.scene import (  # noqa: F401
    Scene,
    load_scene,
    minmax_normalize,
    pad_scene,
    split_labels,
    split_labels_masked,
    synthetic_scene,
)
from dmfusion_torch.data.patches import (gather_dual, gather_one,  # noqa: F401
                                         gather_quad, gather_tri)
