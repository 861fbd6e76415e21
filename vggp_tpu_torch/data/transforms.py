"""Pure numpy track-data transformations (the testable core of the L2 data layer).

The reference welds its ingestion logic into xarray call chains
(``src/utils/dataloaders.py:100-137`` lon wrap / box mask / time concat,
``:428-459`` time-window selection) — untestable without the multi-GB CMEMS
and NATL60 archives. Here every decision is a pure function over a plain
**track record**: a dict of equal-length 1-D numpy arrays (the duck-typed
dataset protocol). The xarray adapters in ``missions.py`` / ``gulfstream.py``
only open files and convert to records; no logic lives in them, so the whole
pipeline is exercised by in-repo fake records.

The port's copy of ``vggp_tpu/data/transforms.py``: numpy in and numpy out, the same arrays.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

Record = Dict[str, np.ndarray]


# --------------------------------------------------------------------------- #
# Record protocol helpers
# --------------------------------------------------------------------------- #

def record_length(record: Record) -> int:
    """Common length of the record's arrays (0 for an empty record)."""
    if not record:
        return 0
    lengths = {np.asarray(v).shape[0] for v in record.values()}
    if len(lengths) != 1:
        raise ValueError(f"ragged record: array lengths {sorted(lengths)}")
    return lengths.pop()


def take(record: Record, idx) -> Record:
    """Row-subset every array of the record (boolean mask or index array)."""
    record_length(record)  # validate alignment before slicing
    return {k: np.asarray(v)[idx] for k, v in record.items()}


def concat_records(records: Sequence[Record]) -> Record:
    """Concatenate records along the observation axis.

    Equivalent of the reference's ``xr.concat(datasets, dim="time")``
    (``dataloaders.py:137``): later months/missions append after earlier
    ones in iteration order. Records must share keys (loud failure beats
    xarray's silent NaN-filled union). Empty inputs (and records emptied by
    filtering) are skipped; no data at all → ``{}`` — the reference's
    "Empty dataset, no data found." fallback (``dataloaders.py:134``).
    """
    records = [r for r in records if record_length(r) > 0]
    if not records:
        return {}
    keys = set(records[0])
    for r in records[1:]:
        if set(r) != keys:
            raise KeyError(
                f"records disagree on variables: {sorted(keys)} vs {sorted(r)}")
    return {k: np.concatenate([np.asarray(r[k]) for r in records])
            for k in records[0]}


# --------------------------------------------------------------------------- #
# Spatial filters
# --------------------------------------------------------------------------- #

def wrap_longitude(lon: np.ndarray) -> np.ndarray:
    """0–360 → ±180 convention (reference ``dataloaders.py:102``:
    ``xr.where(lon > 180, lon - 360, lon)``). 180.0 itself is kept as-is."""
    lon = np.asarray(lon)
    return np.where(lon > 180.0, lon - 360.0, lon)


def box_mask(
    lon: np.ndarray,
    lat: np.ndarray,
    latitude_range: Tuple[float, float],
    longitude_range: Tuple[float, float],
) -> np.ndarray:
    """Strict-inequality lat/lon box (reference ``dataloaders.py:104-106``
    uses ``>`` / ``<``, so points exactly on the box edge are EXCLUDED —
    preserved here for parity)."""
    lon = np.asarray(lon)
    lat = np.asarray(lat)
    lat_min, lat_max = latitude_range
    lon_min, lon_max = longitude_range
    return (lon > lon_min) & (lon < lon_max) & (lat > lat_min) & (lat < lat_max)


def filter_track(
    record: Record,
    latitude_range: Tuple[float, float],
    longitude_range: Tuple[float, float],
    lon_key: str = "longitude",
    lat_key: str = "latitude",
) -> Record:
    """Wrap longitudes then drop rows outside the box — the per-file step of
    ``MissionData.load_data`` (reference ``dataloaders.py:100-111`` with
    ``.where(mask, drop=True)`` semantics on along-track data)."""
    if not record:
        return {}
    out = dict(record)
    out[lon_key] = wrap_longitude(record[lon_key])
    mask = box_mask(out[lon_key], out[lat_key], latitude_range, longitude_range)
    return take(out, mask)


def finite_rows(record: Record, keys: Sequence[str]) -> Record:
    """Drop rows where ANY of ``keys`` is non-finite (NaN gaps in along-track
    altimetry; the reference leaves NaNs in the xarray dataset and they leak
    into training tensors — here the cut is explicit)."""
    if not record:
        return {}
    ok = np.ones(record_length(record), dtype=bool)
    for k in keys:
        ok &= np.isfinite(np.asarray(record[k], dtype=float))
    return take(record, ok)


def subsample(record: Record, sparsity: int) -> Record:
    """Every ``sparsity``-th row (nb61's ``obs_train_data(SPARSITY)``);
    ``sparsity`` ≤ 1 (or falsy) keeps everything."""
    if not record or not sparsity or sparsity <= 1:
        return record
    return take(record, slice(None, None, int(sparsity)))


# --------------------------------------------------------------------------- #
# Time windows
# --------------------------------------------------------------------------- #

def _iso(year: str, month: str, day: str) -> str:
    return f"{int(year):04d}-{int(month):02d}-{int(day):02d}"


def window_bounds(
    year_frame: Tuple[str, str],
    month_frame: Tuple[str, str],
    day_frame: Tuple[str, str],
    hour_frame: Tuple[str, str] | None = None,
) -> Tuple[np.datetime64, np.datetime64]:
    """(start, end_exclusive) datetime64 bounds of the experiment window.

    Matches xarray's partial-string label slice used by the reference
    (``dataloaders.py:428-436``: ``sel(time=slice("Y-M-D H", "Y-M-D H"))``),
    where the end label is inclusive of its whole period — so the exclusive
    bound is the end label plus one hour (or one day when no hour is given).
    """
    start_date = _iso(year_frame[0], month_frame[0], day_frame[0])
    end_date = _iso(year_frame[1], month_frame[1], day_frame[1])
    if hour_frame is None:
        return (np.datetime64(start_date),
                np.datetime64(end_date) + np.timedelta64(1, "D"))
    def _t(date: str, hour: str, last: bool):
        # accepts both "HH" (label-slice inclusive of the whole hour) and
        # the nb61 configs' full "HH:MM:SS" (inclusive of that second) —
        # found by the stub-backed end-to-end run: the shipped EXP_1_*
        # frames use "23:59:59" and crashed the plain-int parse
        if ":" in hour:
            h, m, s = (int(p) for p in hour.split(":"))
            t = np.datetime64(f"{date}T{h:02d}:{m:02d}:{s:02d}")
            return t + np.timedelta64(1, "s") if last else t
        t = np.datetime64(f"{date}T{int(hour):02d}")
        return t + np.timedelta64(1, "h") if last else t

    return (_t(start_date, hour_frame[0], False),
            _t(end_date, hour_frame[1], True))


def time_window_mask(times: np.ndarray, start, end) -> np.ndarray:
    """start ≤ t < end over a datetime64 (or comparable) array."""
    t = np.asarray(times)
    return (t >= start) & (t < end)


def select_time_window(record: Record, start, end, time_key: str = "time") -> Record:
    """Keep rows inside [start, end) — the pure form of the reference's
    ``xr.open_dataset(...).sel(time=slice(start, end))`` (``dataloaders.py:428``)."""
    if not record:
        return {}
    return take(record, time_window_mask(record[time_key], start, end))


def window_dates(
    year_frame: Tuple[str, str],
    month_frame: Tuple[str, str],
    day_frame: Tuple[str, str],
) -> List[Tuple[str, str, str]]:
    """Every calendar day in the inclusive window as (YYYY, MM, DD) strings —
    drives the NATL60 per-day file enumeration (reference
    ``dataloaders.py:438-459`` datetime+timedelta loop)."""
    start = np.datetime64(_iso(year_frame[0], month_frame[0], day_frame[0]))
    end = np.datetime64(_iso(year_frame[1], month_frame[1], day_frame[1]))
    if end < start:
        raise ValueError(f"window end {end} precedes start {start}")
    days = np.arange(start, end + np.timedelta64(1, "D"), np.timedelta64(1, "D"))
    out = []
    for d in days.astype("datetime64[D]").astype(str):
        y, m, dd = d.split("-")
        out.append((y, m, dd))
    return out


def time_mean(fields: Iterable[np.ndarray]) -> np.ndarray:
    """NaN-skipping mean of per-time 2-D snapshots — the reference's
    ``ref_data.mean(dim="time")`` (``dataloaders.py:456``; xarray means skip
    NaN by default, so land/gap cells don't poison the window average)."""
    stack = np.stack([np.asarray(f) for f in fields])
    return np.nanmean(stack, axis=0)


def field_sum_count(arr: np.ndarray, time_axis: Optional[int]) -> Tuple[np.ndarray, np.ndarray]:
    """Per-pixel (NaN-skipping sum, finite count) of one file's snapshots.

    ``time_axis`` is the position of the time dimension, or ``None`` for a
    single 2-D snapshot. Accumulating these per file and dividing once
    (:func:`pooled_time_mean`) reproduces the reference's POOLED
    ``mean(dim="time")`` over a whole window (``dataloaders.py:450-456``)
    while keeping memory flat — unlike a mean of per-file means, which
    diverges whenever files carry unequal (or partially-NaN) time-step
    counts."""
    arr = np.asarray(arr, dtype=np.float64)
    finite = np.isfinite(arr)
    if time_axis is None:
        return np.where(finite, arr, 0.0), finite.astype(np.int64)
    return (np.where(finite, arr, 0.0).sum(axis=time_axis),
            finite.sum(axis=time_axis))


def pooled_time_mean(sums: Iterable[np.ndarray], counts: Iterable[np.ndarray]) -> np.ndarray:
    """Equal-weight-per-TIME-STEP mean from per-file (sum, count) pairs;
    pixels with no finite sample in the window are NaN (xarray semantics)."""
    total = np.sum(np.stack([np.asarray(s) for s in sums]), axis=0)
    n = np.sum(np.stack([np.asarray(c) for c in counts]), axis=0)
    with np.errstate(invalid="ignore"):
        return np.where(n > 0, total / np.maximum(n, 1), np.nan)


# --------------------------------------------------------------------------- #
# Mission-archive assembly (the load_data pipeline, reader-injected)
# --------------------------------------------------------------------------- #

def load_track_records(
    read_month,
    years: Sequence[str],
    months: Sequence[str],
    latitude_range: Tuple[float, float],
    longitude_range: Tuple[float, float],
    log=None,
) -> Record:
    """The full ``MissionData.load_data`` pipeline (reference
    ``dataloaders.py:69-138``) over an injected month reader.

    ``read_month(year, month)`` returns an iterable of raw track records for
    that month (one per file), or an empty iterable when the month directory
    is missing/empty — that is the ONLY thing the xarray adapter does. Each
    record is longitude-wrapped, box-filtered, then everything concatenates
    in (year, month, file) order. No data → ``{}``.
    """
    log = log or (lambda msg: None)
    parts: List[Record] = []
    for year in years:
        for month in months:
            raw = list(read_month(year, month))
            if not raw:
                log(f"> {year}-{month} | no data")
                continue
            parts.extend(
                filter_track(r, latitude_range, longitude_range) for r in raw
            )
            log(f"> {year}-{month} | completed")
    return concat_records(parts)
