from dmfusion_torch.report.excel import Workbook, expo_result  # noqa: F401
from dmfusion_torch.report.png import write_png  # noqa: F401
