"""Gulf Stream SSH data-challenge loader + synthetic stand-in.

Behavioral equivalent of reference ``src/utils/dataloaders.py:381-539``
(``GulfStream``): along-track observations from the 2020a SSH-mapping data
challenge over a time window, plus the NATL60 reference field gridded into
n×n cells by mean / trapezoid / Simpson integration — the ground-truth
gridded product the models' q(v) is scored against.

Coordinate convention (recovers the behavior of the reference's missing
``src.utils.experiments`` module from its nb61 call sites): model inputs X
live on the unit square — lon/lat are min-max scaled by the experiment
extent — and the ground-truth grids are integrated in those *scaled*
coordinates, so a q(v) over ``CellIntegralFeature.from_lims(n, 0, 1)`` cells
is directly comparable to ``grid_ref_data_simpson(n)``.

:class:`SyntheticGulfStream` exposes the identical interface from a
numpy-only synthetic SSH field + synthetic satellite tracks, so the full
Gulf Stream experiment pipeline runs without the (non-redistributable)
data-challenge archives.

The port's copy of ``vggp_tpu/data/gulfstream.py``: numpy in and numpy out, the same arrays.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from vggp_tpu_torch.data.simulation import generate_track, sim_file_name, synthetic_ssh_field
from vggp_tpu_torch.data.transforms import (
    field_sum_count,
    finite_rows,
    pooled_time_mean,
    select_time_window,
    window_bounds,
    window_dates,
    wrap_longitude,
)
from vggp_tpu_torch.utils.integrators import average_grid_2d, simpson_grid_2d, trapz_grid_2d

AVAILABLE_SATELLITES = (
    "envisat", "geosat2", "jason1", "karin_swot", "nadir_swot",
    "topex-poseidon_interleaved",
)

DEFAULT_EXTENT = (-65.0, -55.0, 33.0, 43.0)  # nb61 cell 4 EXTENT


def _require_xarray():
    try:
        import xarray as xr  # noqa: PLC0415
    except ImportError as e:  # pragma: no cover
        raise ImportError(
            "xarray is required for the real Gulf Stream archives; use "
            "SyntheticGulfStream for a data-free run"
        ) from e
    return xr


def _scale_unit(v: np.ndarray, lo: float, hi: float) -> np.ndarray:
    return (v - lo) / (hi - lo)


class _GulfStreamAPI:
    """Shared gridding/observation API over a (field, lons, lats, obs) state."""

    extent: Tuple[float, float, float, float]

    def obs_train_data(self, sparsity: int):
        """(X, y): every ``sparsity``-th track observation; X scaled to [0,1]²."""
        lon, lat, val = self._obs()
        if sparsity and sparsity > 0:
            lon, lat, val = lon[::sparsity], lat[::sparsity], val[::sparsity]
        lo_lon, hi_lon, lo_lat, hi_lat = self.extent
        X = np.stack(
            [_scale_unit(lon, lo_lon, hi_lon), _scale_unit(lat, lo_lat, hi_lat)], axis=1
        )
        return X, val

    # --- ground-truth grids (scaled coordinates; dim1 = lon, dim2 = lat) --- #

    def _field_scaled(self):
        """(field_t, xs, ys): field transposed to [lon, lat] order and the
        scaled coordinate axes."""
        field, lons, lats = self._ref_field()
        lo_lon, hi_lon, lo_lat, hi_lat = self.extent
        xs = _scale_unit(lons, lo_lon, hi_lon)
        ys = _scale_unit(lats, lo_lat, hi_lat)
        return field.T, xs, ys  # field[lat, lon] -> [lon, lat]

    def grid_ref_data_average(self, n_grids: int) -> np.ndarray:
        f, _, _ = self._field_scaled()
        return average_grid_2d(f, n_grids)

    def grid_ref_data_trapz(self, n_grids: int) -> np.ndarray:
        f, xs, ys = self._field_scaled()
        return trapz_grid_2d(f, xs, ys, n_grids)

    def grid_ref_data_simpson(self, n_grids: int) -> np.ndarray:
        f, xs, ys = self._field_scaled()
        return simpson_grid_2d(f, xs, ys, n_grids)

    # subclass hooks
    def _obs(self):  # -> (lon, lat, val)
        raise NotImplementedError

    def _ref_field(self):  # -> (field[lat, lon], lons, lats)
        raise NotImplementedError


class GulfStream(_GulfStreamAPI):
    """Real data-challenge loader (reference ``dataloaders.py:381-539``)."""

    def __init__(
        self,
        obs_root_folder: str,
        ref_root_folder: str,
        satellite_name: str,
        year_frame: Tuple[str, str],
        month_frame: Tuple[str, str],
        day_frame: Tuple[str, str],
        hour_frame: Tuple[str, str],
        extent: Tuple[float, float, float, float] = DEFAULT_EXTENT,
    ):
        if satellite_name not in AVAILABLE_SATELLITES:
            raise ValueError(
                f"Invalid satellite {satellite_name!r}; must be in {AVAILABLE_SATELLITES}"
            )
        if not os.path.exists(ref_root_folder):
            raise AssertionError(f"reference root folder missing: {ref_root_folder}")
        if not os.path.exists(obs_root_folder):
            raise AssertionError(f"observation root folder missing: {obs_root_folder}")
        self.obs_file_path = os.path.join(
            obs_root_folder, f"2020a_SSH_mapping_NATL60_{satellite_name}.nc"
        )
        if not os.path.exists(self.obs_file_path):
            raise AssertionError(f"observation file missing: {self.obs_file_path}")
        self.ref_root_folder = ref_root_folder
        self.satellite_name = satellite_name
        self.year_frame = year_frame
        self.month_frame = month_frame
        self.day_frame = day_frame
        self.hour_frame = hour_frame
        self.extent = extent
        self.obs_data = self._load_obs_data()
        self.ref_data = self._load_ref_data()

    def _load_obs_data(self):
        """Track record of the obs archive cut to the experiment window.

        Thin xarray adapter (open file, pull arrays) + pure
        :func:`transforms.select_time_window` — the reference's
        ``sel(time=slice(start, end))`` (``dataloaders.py:428-436``).
        """
        xr = _require_xarray()
        with xr.open_dataset(self.obs_file_path) as ds:
            var = "ssh_obs" if "ssh_obs" in ds else "ssh_model"
            rec = {
                "time": np.asarray(ds["time"].values).ravel(),
                "lon": np.asarray(ds["lon"].values).ravel(),
                "lat": np.asarray(ds["lat"].values).ravel(),
                "ssh": np.asarray(ds[var].values).ravel(),
            }
        start, end = window_bounds(
            self.year_frame, self.month_frame, self.day_frame, self.hour_frame
        )
        return select_time_window(rec, start, end)

    def _load_ref_data(self):
        """((sums, counts), lons, lats): per-file NaN-skipping per-pixel time
        sums and finite counts over the window, so the final field is the
        POOLED ``mean(dim="time")`` of the reference (``dataloaders.py:456``)
        — a mean of per-file daily means would diverge whenever files carry
        unequal (or partially-NaN) time-step counts. File enumeration comes
        from pure :func:`transforms.window_dates` (reference
        ``dataloaders.py:438-459``); xarray only opens files.
        """
        xr = _require_xarray()
        sums, counts, lons, lats = [], [], None, None
        for y, m, d in window_dates(self.year_frame, self.month_frame, self.day_frame):
            path = os.path.join(self.ref_root_folder, sim_file_name(y, m, d))
            if not os.path.exists(path):
                continue
            with xr.open_dataset(path) as ds:
                dims = ds.sossheig.dims
                taxis = dims.index("time") if "time" in dims else None
                # per-file (sum, count) keeps memory flat per file
                s, c = field_sum_count(np.asarray(ds.sossheig.values), taxis)
                sums.append(s)
                counts.append(c)
                if lons is None:
                    lons = np.asarray(ds.lon.values)
                    lats = np.asarray(ds.lat.values)
        if not sums:
            raise FileNotFoundError(
                f"no NATL60 files for window in {self.ref_root_folder}")
        return (sums, counts), lons, lats

    def _obs(self):
        rec = dict(self.obs_data)
        rec["lon"] = wrap_longitude(rec["lon"])
        rec = finite_rows(rec, ("lon", "lat", "ssh"))
        return rec["lon"], rec["lat"], rec["ssh"]

    def _ref_field(self):
        (sums, counts), lons, lats = self.ref_data
        return pooled_time_mean(sums, counts), lons, lats


class SyntheticGulfStream(_GulfStreamAPI):
    """Same interface from a synthetic SSH field + synthetic tracks.

    The time window only seeds the field (different windows → different
    fields, like different ocean states); tracks mimic the data-challenge
    along-track sampling via :func:`generate_track`.
    """

    def __init__(
        self,
        satellite_name: str = "envisat",
        seed: int = 0,
        n: int = 600,
        extent: Tuple[float, float, float, float] = DEFAULT_EXTENT,
        trajectory_gradient: int = 2,
        track_sparsity: float = 1.0,
        noise_std: float = 0.01,
    ):
        if satellite_name not in AVAILABLE_SATELLITES:
            raise ValueError(
                f"Invalid satellite {satellite_name!r}; must be in {AVAILABLE_SATELLITES}"
            )
        self.satellite_name = satellite_name
        self.extent = extent
        self.seed = seed
        field, lons, lats = synthetic_ssh_field(n=n, extent=extent, seed=seed)
        self._field, self._lons, self._lats = field, lons, lats
        lon, lat, val = generate_track(
            field, lons, lats, trajectory_gradient, track_sparsity, 0
        )
        rng = np.random.default_rng(seed + 1)
        self._track = (lon, lat, val + noise_std * rng.standard_normal(val.shape))

    def _obs(self):
        return self._track

    def _ref_field(self):
        return self._field, self._lons, self._lats
