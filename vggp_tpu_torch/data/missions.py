"""CMEMS L3 along-track altimetry loaders.

Behavioral equivalent of the reference ``src/utils/dataloaders.py:14-180``
(``MissionData`` / ``MissionAgnosticData``): per-mission monthly NetCDF
directories, 0-360 → ±180 longitude wrap, lat/lon box filter, concatenation
along time, empty-dataset fallback.

All decisions live in :mod:`vggp_tpu_torch.data.transforms` as pure numpy
functions over plain track records (dicts of 1-D arrays); the xarray
dependency is confined to :func:`dataset_to_record` / the per-month file
reader, which only open files and pull arrays. A custom ``read_month``
callable (e.g. a test fake) replaces the filesystem+xarray layer entirely.

The port's copy of ``vggp_tpu/data/missions.py``: numpy in and numpy out, the same arrays.
"""

from __future__ import annotations

import os
from typing import Callable, Iterable, Optional, Sequence, Tuple

import numpy as np

from vggp_tpu_torch.data.transforms import (
    Record,
    concat_records,
    finite_rows,
    load_track_records,
    record_length,
)

AVAILABLE_MISSIONS = (
    "e1", "e1g", "e2", "tp", "tpn", "g2", "j1", "j1n", "j1g", "j2",
    "j2n", "j2g", "j3", "j3n", "en", "enn", "c2", "c2n", "al", "alg",
    "h2a", "h2ag", "h2b", "h2c", "s3a", "s3b", "s6a-hr", "s6a-lr",
)


def _require_xarray():
    try:
        import xarray as xr  # noqa: PLC0415
    except ImportError as e:  # pragma: no cover - env without xarray
        raise ImportError(
            "xarray is required for NetCDF mission loading; install xarray "
            "+ netCDF4, or inject a read_month callable / use the synthetic "
            "stand-ins in vggp_tpu_torch.data.simulation / .gulfstream"
        ) from e
    return xr


def dataset_to_record(ds) -> Record:
    """xarray Dataset → plain track record (thin adapter, no logic).

    Keeps the time coordinate plus every 1-D along-track variable
    (longitude, latitude, sla_filtered, …), raveled to numpy.
    """
    rec = {}
    if "time" in ds.coords:
        vals = np.asarray(ds["time"].values)
        if vals.ndim == 1:
            rec["time"] = vals
    for name in ("longitude", "latitude", *ds.data_vars):
        if name in rec or name not in ds:
            continue
        vals = np.asarray(ds[name].values)
        if vals.ndim != 1:
            # >1-D ancillary variables (QC matrices etc.) are not
            # along-track; raveling one would poison the length vote below.
            continue
        rec[name] = vals
    # drop anything not aligned with the track axis (scalar QC vars etc.);
    # the track length is anchored on time/longitude when present.
    for anchor in ("time", "longitude"):
        if anchor in rec:
            n = rec[anchor].shape[0]
            break
    else:
        n = max((v.shape[0] for v in rec.values()), default=0)
    return {k: v for k, v in rec.items() if v.shape[0] == n}


def netcdf_month_reader(mission_folder: str) -> Callable[[str, str], Iterable[Record]]:
    """Default per-month reader over the CMEMS directory layout
    ``<mission_folder>/<year>/<month>/*.nc`` (reference ``dataloaders.py:69-99``).
    Unreadable files are skipped, like the reference's bare try/except."""

    def read_month(year: str, month: str) -> Iterable[Record]:
        data_dir = os.path.join(mission_folder, year, month)
        if not os.path.isdir(data_dir):
            return
        files = sorted(os.path.join(data_dir, f) for f in os.listdir(data_dir))
        if not files:
            return
        xr = _require_xarray()
        for path in files:
            try:
                with xr.open_dataset(path) as ds:
                    rec = dataset_to_record(ds)
            except Exception:  # noqa: BLE001 - reference skips any bad file
                continue
            yield rec

    return read_month


class MissionData:
    """Along-track sea-level observations for one altimetry mission.

    ``mission_data`` is a plain track record (dict of 1-D numpy arrays);
    empty (``{}``) when no data was found — the reference's empty-Dataset
    fallback (``dataloaders.py:134``). Directory layout matches the CMEMS
    archive the reference uses:
    ``<root>/cmems_obs-sl_eur_phy-ssh_my_<mission>-l3-duacs_PT1S/<year>/<month>/*.nc``.
    """

    def __init__(
        self,
        root_folder: str,
        mission_name: str,
        years: Sequence[str],
        months: Sequence[str],
        latitude_range: Tuple[float, float] = (-90.0, 90.0),
        longitude_range: Tuple[float, float] = (-180.0, 180.0),
        verbose: bool = True,
        read_month: Optional[Callable[[str, str], Iterable[Record]]] = None,
    ):
        if mission_name not in AVAILABLE_MISSIONS:
            raise ValueError(
                f"Invalid mission name {mission_name!r}; must be one of {AVAILABLE_MISSIONS}"
            )
        self.mission_name = mission_name
        self.mission_folder = os.path.join(
            root_folder, f"cmems_obs-sl_eur_phy-ssh_my_{mission_name}-l3-duacs_PT1S"
        )
        self.years = list(years)
        self.months = list(months)
        self.min_latitude, self.max_latitude = latitude_range
        self.min_longitude, self.max_longitude = longitude_range
        self.verbose = verbose
        self._read_month = read_month or netcdf_month_reader(self.mission_folder)
        self.mission_data = self.load_data()

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(msg)

    def load_data(self) -> Record:
        return load_track_records(
            self._read_month,
            self.years,
            self.months,
            (self.min_latitude, self.max_latitude),
            (self.min_longitude, self.max_longitude),
            log=self._log,
        )

    def __len__(self) -> int:
        return record_length(self.mission_data)

    def observations(self, var: str = "sla_filtered"):
        """(lon, lat, value) numpy arrays of non-NaN observations."""
        rec = self.mission_data
        if var not in rec:
            raise KeyError(f"{var!r} not in mission record (vars: {sorted(rec)})")
        rec = finite_rows(rec, ("longitude", "latitude", var))
        return rec["longitude"], rec["latitude"], rec[var]


class MissionAgnosticData:
    """Concatenation of several missions over the same box/time window
    (reference ``dataloaders.py:141-180``). ``data`` is a track record."""

    def __init__(
        self,
        root_folder: str,
        mission_names: Sequence[str],
        years: Sequence[str],
        months: Sequence[str],
        latitude_range: Tuple[float, float] = (-90.0, 90.0),
        longitude_range: Tuple[float, float] = (-180.0, 180.0),
        verbose: bool = True,
        read_month_for: Optional[Callable[[str], Callable[[str, str], Iterable[Record]]]] = None,
    ):
        self.missions = [
            MissionData(
                root_folder, name, years, months, latitude_range,
                longitude_range, verbose=verbose,
                read_month=read_month_for(name) if read_month_for else None,
            )
            for name in mission_names
        ]
        self.data = concat_records([m.mission_data for m in self.missions])
