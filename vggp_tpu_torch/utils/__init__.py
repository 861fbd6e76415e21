"""Data and evaluation utilities of the port (``vggp_tpu/utils/``):
metrics and scalers on tensors, the numpy data generators and integrators
as the port's own copies. ``smoke_cases.py``'s counterpart is the family
cases of ``chip_smoke.py``."""

from vggp_tpu_torch.utils import datagen, integrators, metrics, scalers  # noqa: F401
from vggp_tpu_torch.utils.datagen import gen_1d, gen_2d  # noqa: F401
from vggp_tpu_torch.utils.integrators import (  # noqa: F401
    average_grid_2d,
    grad_trapz_grid_2d,
    integrate_1d,
    simpson_grid_2d,
    trapz_grid_2d,
)
from vggp_tpu_torch.utils.metrics import (  # noqa: F401
    evaluation_metric_row,
    mean_absolute_error,
    mean_squared_error,
    mean_squared_log_loss,
    mean_standardized_log_loss,
    negative_log_predictive_density,
    r_squared,
    root_mean_squared_error,
)
from vggp_tpu_torch.utils.scalers import (  # noqa: F401
    min_max_inverse,
    min_max_scaling,
    z_inverse,
    z_scaling,
)
