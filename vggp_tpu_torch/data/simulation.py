"""NATL60 Gulf Stream SSH simulation loading + synthetic track generation.

Behavioral equivalent of the reference ``src/utils/dataloaders.py:183-377``
(``SimulationData``/``SimulationDataDay``/``SimulationDataHour`` and
``generate_track``). Differences by design:

- :func:`generate_track` is a standalone numpy function over any square
  field (the reference hard-codes the 600×600 NATL60 grid and its class's
  xarray handle), so it works for both real and synthetic fields;
- :func:`synthetic_ssh_field` produces a NATL60-like eddying jet field so
  the Gulf Stream experiments run without the (multi-GB, non-redistributed)
  simulation archive.

The port's copy of ``vggp_tpu/data/simulation.py``: numpy in and numpy out, the same arrays.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np


def _require_xarray():
    try:
        import xarray as xr  # noqa: PLC0415
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "xarray is required for NATL60 NetCDF loading; use "
            "synthetic_ssh_field / SyntheticGulfStream without it"
        ) from e
    return xr


def sim_file_name(year: str, month: str, day: str) -> str:
    return f"NATL60-CJM165_GULFSTREAM_y{year}m{month}d{day}.1h_SSH.nc"


class _SimulationBase:
    def __init__(self, root_folder: str, year: str, month: str, day: str):
        path = os.path.join(root_folder, sim_file_name(year, month, day))
        if not os.path.exists(path):
            raise ValueError(f"File {path} does not exist.")
        self.simulation_year = year
        self.simulation_month = month
        self.simulation_day = day
        self.simulation_name = f"NATL60-CJM165_GULFSTREAM_y{year}m{month}d{day}"
        self.simulation_file_path = path


class SimulationDataDay(_SimulationBase):
    """Whole-day (24 h) simulation snapshot set."""

    def __init__(self, root_folder: str, year: str, month: str, day: str):
        super().__init__(root_folder, year, month, day)
        self.data = self.load_data()

    def load_data(self):
        xr = _require_xarray()
        return xr.open_dataset(self.simulation_file_path)


class SimulationDataHour(_SimulationBase):
    """A single simulation hour; supports synthetic track generation."""

    def __init__(self, root_folder: str, year: str, month: str, day: str, hour: int):
        super().__init__(root_folder, year, month, day)
        if hour < 0 or hour > 23:
            raise ValueError(f"Hour must be between 0 and 23, got {hour}")
        self.hour = hour
        self.data = self.load_data()

    def load_data(self):
        xr = _require_xarray()
        return xr.open_dataset(self.simulation_file_path).isel(time=self.hour)

    def generate_track(
        self, trajectory_gradient: int, track_sparsity: float, observation_sparsity: int
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        field = np.asarray(self.data.sossheig.values)
        lons = np.asarray(self.data.lon.values)
        lats = np.asarray(self.data.lat.values)
        return generate_track(
            field, lons, lats, trajectory_gradient, track_sparsity, observation_sparsity
        )


def generate_track(
    field: np.ndarray,
    lons: np.ndarray,
    lats: np.ndarray,
    trajectory_gradient: int,
    track_sparsity: float,
    observation_sparsity: int,
    degree_range: float = 10.0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Synthetic satellite ground tracks over a square field.

    Diagonal ascending+descending passes (slope ``trajectory_gradient`` in
    grid steps per longitude step), spaced ``track_sparsity`` degrees apart,
    launched both from the longitude axis and (sparsity-adjusted) from the
    latitude axis; every ``observation_sparsity``-th sample kept. Semantics
    follow reference ``dataloaders.py:290-377``; indices are computed
    vectorized rather than via Python append loops.

    ``field`` is indexed ``field[lat_idx, lon_idx]``.
    """
    if not (0 < track_sparsity <= 10):
        raise ValueError(f"Track sparsity must be in (0, 10], got {track_sparsity}")
    n_lat, n_lon = field.shape
    if n_lat != n_lon:
        raise ValueError("generate_track expects a square field")
    dim = n_lon

    lon_idx_parts = []
    lat_idx_parts = []

    # tracks launched from the longitude axis
    max_lon_idx = int(dim / trajectory_gradient)
    n_lon_tracks = int(degree_range / track_sparsity)
    shift_size = track_sparsity * (dim / degree_range)
    for i in range(n_lon_tracks):
        start = int(i * shift_size)
        end = min(int(max_lon_idx + start), dim)
        fwd_lon = np.repeat(np.arange(start, end), trajectory_gradient)
        k = len(fwd_lon)
        # ascending pass then descending pass
        lon_idx_parts.append(np.concatenate([fwd_lon, fwd_lon]))
        lat_idx_parts.append(np.concatenate([np.arange(k), np.arange(-1, -k - 1, -1)]))

    # tracks launched from the latitude axis (sparsity scaled by gradient)
    lat_sparsity = track_sparsity * trajectory_gradient
    n_lat_tracks = int(degree_range / lat_sparsity)
    lat_shift_size = lat_sparsity * (dim / degree_range)
    for j in range(n_lat_tracks):
        start = int(j * lat_shift_size)
        fwd_lat = np.arange(start, dim)
        bwd_lat = np.arange(-start, -dim, -1)
        lon_rep = np.repeat(np.arange(0, max_lon_idx), trajectory_gradient)
        # lon_rep has max_lon_idx*gradient entries, which is < dim when the
        # gradient does not divide the field size — truncate the pass lengths
        # to whichever runs out first so the index arrays stay aligned.
        kf = min(len(fwd_lat), len(lon_rep))
        kb = min(len(bwd_lat), len(lon_rep))
        lat_idx_parts.append(np.concatenate([fwd_lat[:kf], bwd_lat[:kb]]))
        lon_idx_parts.append(np.concatenate([lon_rep[:kf], lon_rep[:kb]]))

    lon_idx = np.concatenate(lon_idx_parts).astype(int)
    lat_idx = np.concatenate(lat_idx_parts).astype(int)
    track_lon = lons[lon_idx]
    track_lat = lats[lat_idx]
    track_val = field[lat_idx, lon_idx]
    if observation_sparsity and observation_sparsity > 0:
        sl = slice(None, None, observation_sparsity)
        return track_lon[sl], track_lat[sl], track_val[sl]
    return track_lon, track_lat, track_val


def synthetic_ssh_field(
    n: int = 600,
    extent: Tuple[float, float, float, float] = (-65.0, -55.0, 33.0, 43.0),
    seed: int = 0,
    n_eddies: int = 40,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A NATL60-like synthetic SSH snapshot: meandering jet + mesoscale eddies.

    Returns ``(field, lons, lats)`` with ``field[lat_idx, lon_idx]`` in
    meters (O(±0.5) amplitude like Gulf Stream SSH). Deterministic in
    ``seed``. Used wherever the reference loads the (non-redistributable)
    NATL60 archive.
    """
    rng = np.random.default_rng(seed)
    lon_min, lon_max, lat_min, lat_max = extent
    lons = np.linspace(lon_min, lon_max, n)
    lats = np.linspace(lat_min, lat_max, n)
    LON, LAT = np.meshgrid(lons, lats)

    # meandering jet: sharp SSH front along a sinuous latitude
    center = 0.5 * (lat_min + lat_max)
    meander = 1.2 * np.sin(2.0 * np.pi * (LON - lon_min) / 6.5) + 0.6 * np.sin(
        2.0 * np.pi * (LON - lon_min) / 2.3 + 1.0
    )
    field = 0.45 * np.tanh((LAT - (center + meander)) / 0.8)

    # mesoscale eddies: random Gaussian bumps, 0.3–1.2 degree radii
    for _ in range(n_eddies):
        cx = rng.uniform(lon_min, lon_max)
        cy = rng.uniform(lat_min, lat_max)
        r = rng.uniform(0.3, 1.2)
        amp = rng.uniform(0.05, 0.25) * rng.choice([-1.0, 1.0])
        field += amp * np.exp(-(((LON - cx) ** 2 + (LAT - cy) ** 2) / (2 * r * r)))

    return field, lons, lats
