"""Models of the port: the SVGP (``svgp``), the collapsed GP over any
feature family (``sgpr``), the exact GP (``exact``), the collapsed families
of the additive (``additive``), sum-of-kernels (``sum``) and free-point
(``freesvgp``) models, and the matrix-free CG heads (``iterative``);
``common`` holds what they share. The six specs and seven modules are
re-exported as ``vggp_tpu/models/__init__.py`` does. None of the modules
imports a module that imports this package back at its top level
(``iterative`` imports ``sampling`` where it draws)."""

from vggp_tpu_torch.models.exact import ExactGPSpec
from vggp_tpu_torch.models.sgpr import SGPRSpec
from vggp_tpu_torch.models.svgp import SVGPSpec
from vggp_tpu_torch.models.additive import AdditiveSGPRSpec
from vggp_tpu_torch.models.freesvgp import FreeSVGPSpec
from vggp_tpu_torch.models.sum import SumSGPRSpec
from vggp_tpu_torch.models import (  # noqa: F401,A004
    additive, exact, freesvgp, iterative, sgpr, sum, svgp)

__all__ = ["ExactGPSpec", "SGPRSpec", "SVGPSpec", "AdditiveSGPRSpec",
           "FreeSVGPSpec", "SumSGPRSpec", "exact", "sgpr", "svgp", "additive",
           "freesvgp", "iterative", "sum"]
