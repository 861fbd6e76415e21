"""vggp_tpu_torch — the PyTorch and CUDA port of vggp_tpu for one NVIDIA H100.

The JAX package ``vggp_tpu`` is the reference; this package mirrors its
module layout and parameter trees. Entry points run on ``cuda`` unless the
caller passes another device, and raise when no card is present. ``GP``,
``SVGP`` and ``Streaming`` are the object facades of :mod:`api`, as in the
JAX package; the SVGP module class is ``models.svgp.SVGP``.
"""

from vggp_tpu_torch import basis, config, convert, features, kernels, likelihoods, train  # noqa: F401
from vggp_tpu_torch.features import (  # noqa: F401
    AxisFeature, B1SplineFeature, B2SplineFeature, B3SplineFeature, CellIntegralFeature,
    FourierFeature, OutputFeature, PointFeature, SplineRKHSFeature)
from vggp_tpu_torch.models import (  # noqa: F401,A004
    additive, common, exact, freesvgp, iterative, sgpr, sum, svgp)
from vggp_tpu_torch import sampling, streaming  # noqa: F401,E402
from vggp_tpu_torch.models.additive import AdditiveSGPR, AdditiveSGPRSpec  # noqa: F401
from vggp_tpu_torch.models.common import Gaussian  # noqa: F401
from vggp_tpu_torch.models.exact import ExactGP, ExactGPSpec  # noqa: F401
from vggp_tpu_torch.models.freesvgp import FreeSVGP, FreeSVGPSpec  # noqa: F401
from vggp_tpu_torch.models.sgpr import SGPR, SGPRSpec  # noqa: F401
from vggp_tpu_torch.models.sum import SumSGPR, SumSGPRSpec  # noqa: F401
from vggp_tpu_torch.models.svgp import SVGPSpec  # noqa: F401
from vggp_tpu_torch import api, data, hyperpost, models, ops, parallel, utils  # noqa: F401,E402
from vggp_tpu_torch.api import GP, SVGP, Streaming  # noqa: F401,E402
