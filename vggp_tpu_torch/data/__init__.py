"""Data layer: altimetry mission loaders, Gulf Stream simulation, synthetic
stand-ins (reference ``src/utils/dataloaders.py`` equivalents).

xarray/netCDF are optional: the real-data loaders (:class:`MissionData`,
:class:`SimulationDataHour`, :class:`GulfStream`) import xarray lazily and
raise a clear error if it is missing; every experiment also runs against the
numpy-only synthetic stand-ins (:func:`synthetic_ssh_field`,
:class:`SyntheticGulfStream`) so the full pipeline is exercisable without
the CMEMS/NATL60 archives.

The port's copy of ``vggp_tpu/data/``: numpy in and numpy out, the same arrays.
"""

from vggp_tpu_torch.data import transforms
from vggp_tpu_torch.data.missions import MissionData, MissionAgnosticData
from vggp_tpu_torch.data.simulation import (
    SimulationDataDay,
    SimulationDataHour,
    generate_track,
    synthetic_ssh_field,
)
from vggp_tpu_torch.data.gulfstream import GulfStream, SyntheticGulfStream

__all__ = [
    "MissionData",
    "MissionAgnosticData",
    "SimulationDataDay",
    "SimulationDataHour",
    "generate_track",
    "synthetic_ssh_field",
    "GulfStream",
    "SyntheticGulfStream",
    "transforms",
]
