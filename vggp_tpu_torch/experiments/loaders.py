"""``load_gulf_stream_data`` (reference's missing ``src.utils.experiments``).

Returns a real :class:`~vggp_tpu_torch.data.gulfstream.GulfStream` when the
data-challenge archives exist at the given roots, otherwise a seeded
:class:`~vggp_tpu_torch.data.gulfstream.SyntheticGulfStream` with the same
interface — the experiment scripts run either way. The port's copy of
``vggp_tpu/experiments/loaders.py``: the same crc32 seed, so the synthetic
windows are the same arrays.
"""

from __future__ import annotations

import os
from typing import Dict

from vggp_tpu_torch.data.gulfstream import GulfStream, SyntheticGulfStream


def load_gulf_stream_data(
    obs_root_folder: str, ref_root_folder: str, exp_dict: Dict, allow_synthetic: bool = True
):
    """Load the observation + reference data described by an experiment dict
    (nb61 cell 8 call shape)."""
    sat = exp_dict["SATELLITE"]
    obs_file = os.path.join(obs_root_folder, f"2020a_SSH_mapping_NATL60_{sat}.nc")
    if os.path.exists(obs_file) and os.path.isdir(ref_root_folder):
        return GulfStream(
            obs_root_folder,
            ref_root_folder,
            sat,
            exp_dict["YEAR_FRAME"],
            exp_dict["MONTH_FRAME"],
            exp_dict["DAY_FRAME"],
            exp_dict["HOUR_FRAME"],
        )
    if not allow_synthetic:
        raise FileNotFoundError(f"Gulf Stream archives not found under {obs_root_folder}")
    # deterministic per-window seed so train/val/test windows differ.
    # zlib.crc32 of a canonical repr — Python's hash() is salted per process
    # (PYTHONHASHSEED), which made committed results irreproducible.
    import zlib

    key = "|".join(
        str(exp_dict[k]) for k in ("YEAR_FRAME", "MONTH_FRAME", "DAY_FRAME")
    )
    seed = zlib.crc32(f"{sat}|{key}".encode()) % (2**31)
    return SyntheticGulfStream(satellite_name=sat, seed=seed)
