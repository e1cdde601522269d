from dmfusion_torch.utils.misc import (  # noqa: F401
    data_show,
    parse_switch,
    seed_everything,
)
