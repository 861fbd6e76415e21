"""The port's ``data/`` (``vggp_tpu_torch.data``) against the JAX package's
``vggp_tpu.data``: every public function and class on the inputs of
tests/test_data.py, tests/test_transforms.py and
tests/test_xarray_adapters.py, the arrays equal exactly.

Each case is a scenario run once through each package; the results (arrays,
scalars, records, and any exception's type and message) must be identical.
The real-archive loaders run through a copy of the xarray stub of
tests/test_xarray_adapters.py: neither package may import xarray eagerly.
"""

import sys
import types
from types import SimpleNamespace

import numpy as np
import pytest

import vggp_tpu.data as jdata
import vggp_tpu_torch.data as tdata
from vggp_tpu.data import gulfstream as jgulf
from vggp_tpu.data import missions as jmissions
from vggp_tpu.data import simulation as jsim
from vggp_tpu.data import transforms as jtr
from vggp_tpu_torch.data import gulfstream as tgulf
from vggp_tpu_torch.data import missions as tmissions
from vggp_tpu_torch.data import simulation as tsim
from vggp_tpu_torch.data import transforms as ttr

JAX = SimpleNamespace(data=jdata, tr=jtr, missions=jmissions, sim=jsim, gulf=jgulf)
PORT = SimpleNamespace(data=tdata, tr=ttr, missions=tmissions, sim=tsim, gulf=tgulf)


def _same(a, b, where="result"):
    """a and b equal exactly: arrays (NaN where NaN, same dtype and shape),
    dicts, sequences, scalars, exceptions by type name and message."""
    if isinstance(a, BaseException):
        assert isinstance(b, BaseException), f"{where}: {b!r} where {a!r} was raised"
        assert (type(a).__name__, str(a)) == (type(b).__name__, str(b)), where
        return
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b), f"{where}: keys {list(a)} {list(b)}"
        for k in a:
            _same(a[k], b[k], f"{where}[{k!r}]")
        return
    if isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b), f"{where}: {a!r} vs {b!r}"
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{where}[{i}]")
        return
    if isinstance(a, (np.ndarray, np.generic)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, f"{where}: {a.dtype}{a.shape} " \
                                                          f"vs {b.dtype}{b.shape}"
        np.testing.assert_array_equal(a, b, err_msg=where, strict=True)
        return
    assert type(a) is type(b) and a == b, f"{where}: {a!r} vs {b!r}"


def _run(scenario, pkg, *args):
    try:
        return scenario(pkg, *args)
    except Exception as e:  # noqa: BLE001 - the exception is the result compared
        return e


def _both(scenario, *args):
    want = _run(scenario, JAX, *args)
    got = _run(scenario, PORT, *args)
    _same(want, got)
    return got


def test_public_names_match():
    assert tdata.__all__ == jdata.__all__
    for mod_j, mod_t in ((jtr, ttr), (jmissions, tmissions), (jsim, tsim), (jgulf, tgulf)):
        public = sorted(k for k in vars(mod_j) if not k.startswith("_")
                        and getattr(vars(mod_j)[k], "__module__", mod_j.__name__)
                        == mod_j.__name__)
        assert public, mod_j.__name__
        for name in public:
            assert hasattr(mod_t, name), f"{mod_t.__name__} lacks {name}"
    assert tgulf.AVAILABLE_SATELLITES == jgulf.AVAILABLE_SATELLITES
    assert tgulf.DEFAULT_EXTENT == jgulf.DEFAULT_EXTENT


# --------------------------------------------------------------------------- #
# transforms.py (tests/test_transforms.py's inputs)
# --------------------------------------------------------------------------- #

def make_record(lon, lat, val=None, time=None):
    lon = np.asarray(lon, dtype=float)
    rec = {"longitude": lon, "latitude": np.asarray(lat, dtype=float)}
    rec["sla_filtered"] = (np.asarray(val, dtype=float) if val is not None
                           else np.zeros_like(lon))
    if time is not None:
        rec["time"] = np.asarray(time)
    return rec


def fake_reader(data):
    def read_month(year, month):
        return data.get((year, month), [])
    return read_month


def _spatial(pkg):
    tr = pkg.tr
    lon = np.array([0.0, 179.9, 180.0, 180.1, 359.0, 300.0, -10.0])
    rec = make_record(lon=[299.0, 305.1, 10.0], lat=[38.0, 38.0, 38.0], val=[1, 2, 3])
    nan_rec = make_record(lon=[1.0, 2.0, 3.0], lat=[0.0, np.nan, 0.0], val=[9.0, 9.0, np.nan])
    ten = make_record(lon=np.arange(10.0), lat=np.zeros(10))
    return {
        "wrap": tr.wrap_longitude(lon),
        "box": tr.box_mask(np.array([-65.0, -60.0, -55.0, -70.0]),
                           np.array([33.0, 38.0, 43.0, 38.0]),
                           latitude_range=(33.0, 43.0), longitude_range=(-65.0, -55.0)),
        "filter": tr.filter_track(rec, latitude_range=(33.0, 43.0),
                                  longitude_range=(-65.0, -50.0)),
        "finite": tr.finite_rows(nan_rec, ("longitude", "latitude", "sla_filtered")),
        "subsample": tr.subsample(ten, 3),
        "subsample identity": (tr.subsample(ten, 0) is ten, tr.subsample(ten, 1) is ten),
        "take": tr.take(ten, np.array([7, 1, 1])),
    }


def _records(pkg):
    tr = pkg.tr
    a = make_record(lon=[1.0], lat=[0.0], val=[10.0])
    b = make_record(lon=[2.0, 3.0], lat=[0.0, 0.0], val=[20.0, 30.0])
    return {"concat": tr.concat_records([a, {}, b]), "empty": tr.concat_records([]),
            "empties": tr.concat_records([{}, {}]), "length": tr.record_length(b),
            "length of nothing": tr.record_length({})}


def _mismatched_keys(pkg):
    a = make_record(lon=[1.0], lat=[0.0])
    return pkg.tr.concat_records([a, {"longitude": np.array([2.0]),
                                      "latitude": np.array([0.0])}])


def _ragged(pkg):
    return pkg.tr.record_length({"a": np.zeros(3), "b": np.zeros(4)})


def _windows(pkg):
    tr = pkg.tr
    t = np.arange(np.datetime64("2012-10-01T00"), np.datetime64("2012-10-02T00"),
                  np.timedelta64(1, "h"))
    rec = {"time": t, "v": np.arange(len(t), dtype=float)}
    start, end = tr.window_bounds(("2012", "2012"), ("10", "10"), ("01", "01"), ("06", "08"))
    return {
        "bounds hours": tr.window_bounds(("2012", "2012"), ("10", "10"), ("01", "05"),
                                         ("00", "23")),
        "bounds days": tr.window_bounds(("2012", "2012"), ("10", "10"), ("01", "05")),
        "mask": tr.time_window_mask(t, start, end),
        "select": tr.select_time_window(rec, start, end),
        "dates": tr.window_dates(("2012", "2012"), ("10", "11"), ("30", "02")),
    }


def _dates_reversed(pkg):
    return pkg.tr.window_dates(("2013", "2012"), ("01", "01"), ("01", "01"))


def _means(pkg):
    tr = pkg.tr
    a = np.array([[1.0, np.nan], [2.0, 4.0]])
    b = np.array([[3.0, 6.0], [np.nan, 8.0]])
    rng = np.random.default_rng(0)
    f1 = rng.standard_normal((5, 3, 4))
    f2 = rng.standard_normal((2, 3, 4))
    f2[0, 1, 1] = np.nan
    f3 = rng.standard_normal((3, 4))
    pairs = [tr.field_sum_count(f1, 0), tr.field_sum_count(f2, 0), tr.field_sum_count(f3, None)]
    g = tr.field_sum_count(np.full((2, 2, 2), np.nan), 0)
    return {"time_mean": tr.time_mean([a, b]), "pairs": pairs,
            "pooled": tr.pooled_time_mean([s for s, _ in pairs], [c for _, c in pairs]),
            "pooled nan": tr.pooled_time_mean([g[0]], [g[1]])}


def _pipeline(pkg):
    tr = pkg.tr
    data = {
        ("2013", "04"): [make_record(lon=[299.0, 10.0], lat=[38.0, 38.0], val=[1.0, 99.0]),
                         make_record(lon=[-60.0], lat=[40.0], val=[2.0])],
        ("2013", "05"): [make_record(lon=[-58.0], lat=[35.0], val=[3.0])],
    }
    return {
        "records": tr.load_track_records(fake_reader(data), years=["2013"],
                                         months=["04", "05", "06"],
                                         latitude_range=(33.0, 43.0),
                                         longitude_range=(-65.0, -50.0)),
        "all filtered": tr.load_track_records(
            fake_reader({("2013", "04"): [make_record(lon=[10.0], lat=[0.0])]}), ["2013"],
            ["04"], (33.0, 43.0), (-65.0, -50.0)),
    }


def _mission_injected(pkg):
    data = {("2013", "04"): [make_record(lon=[-60.0, -59.0], lat=[40.0, np.nan],
                                         val=[2.0, 5.0])]}
    md = pkg.missions.MissionData("/nonexistent", "al", ["2013"], ["04"],
                                  latitude_range=(33.0, 43.0), longitude_range=(-65.0, -50.0),
                                  verbose=False, read_month=fake_reader(data))
    per_mission = {
        "al": {("2013", "04"): [make_record(lon=[-60.0], lat=[40.0], val=[1.0])]},
        "en": {("2013", "04"): [make_record(lon=[-59.0], lat=[39.0], val=[2.0])]},
        "j2": {},
    }
    mad = pkg.missions.MissionAgnosticData(
        "/nonexistent", ["al", "en", "j2"], ["2013"], ["04"],
        latitude_range=(33.0, 43.0), longitude_range=(-65.0, -50.0),
        verbose=False, read_month_for=lambda name: fake_reader(per_mission[name]))
    try:
        md.observations("nope")
        missing = None
    except KeyError as e:
        missing = e
    return {"len": len(md), "record": md.mission_data, "obs": md.observations(),
            "missing var": missing, "agnostic": mad.data}


def _mission_missing_archive(pkg, root):
    md = pkg.missions.MissionData(str(root), "al", ["2013"], ["04"], verbose=False)
    return {"record": md.mission_data, "len": len(md)}


def _mission_bad_name(pkg, root):
    return pkg.missions.MissionData(str(root), "not-a-mission", ["2013"], ["04"])


class _FakeVar:
    def __init__(self, values, dims=("time",)):
        self.values = np.asarray(values)
        self.dims = tuple(dims)


class _FakeDataset:
    """The xarray.Dataset surface the adapters touch (the stub of
    tests/test_xarray_adapters.py, plus ``isel`` over a leading time axis
    for ``SimulationDataHour``)."""

    def __init__(self, coords=None, data_vars=None):
        self.coords = {k: _FakeVar(v) for k, v in (coords or {}).items()}
        self.data_vars = {k: (v if isinstance(v, _FakeVar) else _FakeVar(v))
                          for k, v in (data_vars or {}).items()}

    def __contains__(self, name):
        return name in self.coords or name in self.data_vars

    def __getitem__(self, name):
        if name in self.coords:
            return self.coords[name]
        return self.data_vars[name]

    def __getattr__(self, name):
        vars_ = object.__getattribute__(self, "data_vars")
        if name in vars_:
            return vars_[name]
        raise AttributeError(name)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def isel(self, time):
        out = {k: (_FakeVar(v.values[time], v.dims[1:]) if v.dims[:1] == ("time",) else v)
               for k, v in self.data_vars.items()}
        return _FakeDataset(data_vars=out)


def _dataset_to_record(pkg):
    n = 5
    higher = _FakeDataset(coords={"time": np.arange(n)}, data_vars={
        "longitude": np.linspace(-60, -59, n), "latitude": np.linspace(38, 39, n),
        "sla_filtered": np.ones(n), "qc_matrix": np.zeros((n, 2)),
        "scalar_flag": np.asarray(3.0)})
    longer = _FakeDataset(coords={"time": np.arange(4)}, data_vars={
        "longitude": np.zeros(4), "latitude": np.zeros(4), "sla_filtered": np.ones(4),
        "bounds_1d": np.zeros(9)})
    return [pkg.missions.dataset_to_record(higher), pkg.missions.dataset_to_record(longer)]


@pytest.fixture
def xarray_stub():
    """A fake xarray whose open_dataset reads from a path registry."""
    registry = {}

    def open_dataset(path):
        ds = registry.get(str(path))
        if ds is None:
            raise OSError(f"not a NetCDF file: {path}")
        return ds

    mod = types.ModuleType("xarray")
    mod.open_dataset = open_dataset
    saved = sys.modules.get("xarray")
    sys.modules["xarray"] = mod
    try:
        yield registry
    finally:
        if saved is None:
            del sys.modules["xarray"]
        else:
            sys.modules["xarray"] = saved


def _track_ds(lon, lat, sla, t0="2019-01-03T00"):
    n = len(lon)
    t = np.datetime64(t0) + np.arange(n) * np.timedelta64(1, "s")
    return _FakeDataset(coords={"time": t}, data_vars={
        "longitude": np.asarray(lon, np.float64), "latitude": np.asarray(lat, np.float64),
        "sla_filtered": np.asarray(sla, np.float64),
        "qc_matrix": _FakeVar(np.zeros((n, 3)), dims=("time", "q"))})


def _missions_real(pkg, root):
    md = pkg.missions.MissionData(str(root), "j3", years=["2019"], months=["01"],
                                  latitude_range=(30.0, 45.0), longitude_range=(-65.0, -55.0),
                                  verbose=False)
    ma = pkg.missions.MissionAgnosticData(str(root), ["j3", "al"], years=["2019"],
                                          months=["02"], latitude_range=(30.0, 45.0),
                                          longitude_range=(-65.0, -50.0), verbose=False)
    empty = pkg.missions.MissionData(str(root), "j3", years=["2018"], months=["01"],
                                     verbose=False)
    reader = pkg.missions.netcdf_month_reader(
        str(root / "cmems_obs-sl_eur_phy-ssh_my_j3-l3-duacs_PT1S"))
    return {"record": md.mission_data, "len": len(md), "obs": md.observations(),
            "agnostic": ma.data, "empty": (empty.mission_data, len(empty)),
            "reader": list(reader("2019", "01"))}


@pytest.mark.parametrize("scenario", [_spatial, _records, _mismatched_keys, _ragged, _windows,
                                      _dates_reversed, _means, _pipeline],
                         ids=["spatial", "records", "mismatched keys", "ragged", "windows",
                              "reversed dates", "means", "pipeline"])
def test_transforms_match(scenario):
    _both(scenario)


@pytest.mark.parametrize("scenario", [_mission_injected, _dataset_to_record],
                         ids=["injected readers", "dataset_to_record"])
def test_missions_match(scenario):
    _both(scenario)


@pytest.mark.parametrize("scenario", [_mission_missing_archive, _mission_bad_name],
                         ids=["missing archive", "bad name"])
def test_mission_archives_match(scenario, tmp_path):
    _both(scenario, tmp_path)


def test_missions_real_loader_match(tmp_path, xarray_stub):
    """MissionData and MissionAgnosticData through netcdf_month_reader and
    the stub's open_dataset: a wrapped, box-filtered track, a bad file
    skipped, a 2-D ancillary dropped, two missions concatenated."""
    d = tmp_path / "cmems_obs-sl_eur_phy-ssh_my_j3-l3-duacs_PT1S" / "2019" / "01"
    d.mkdir(parents=True)
    for name in ("a_track.nc", "b_track.nc", "z_bad.nc"):
        (d / name).write_bytes(b"")
    xarray_stub[str(d / "a_track.nc")] = _track_ds(
        lon=[300.0, 301.0, 10.0, 11.0], lat=[35.0, 36.0, 35.5, 80.0], sla=[0.1, 0.2, 0.3, 0.4])
    xarray_stub[str(d / "b_track.nc")] = _track_ds(
        lon=[302.0, 303.0], lat=[37.0, 38.0], sla=[0.5, np.nan])
    for mission, lon0 in (("j3", 300.0), ("al", 304.0)):
        dm = tmp_path / f"cmems_obs-sl_eur_phy-ssh_my_{mission}-l3-duacs_PT1S" / "2019" / "02"
        dm.mkdir(parents=True)
        (dm / "t.nc").write_bytes(b"")
        xarray_stub[str(dm / "t.nc")] = _track_ds(lon=[lon0, lon0 + 1.0], lat=[36.0, 37.0],
                                                 sla=[1.0, 2.0])
    got = _both(_missions_real, tmp_path)
    assert got["len"] == 4


# --------------------------------------------------------------------------- #
# simulation.py and gulfstream.py (tests/test_data.py's inputs)
# --------------------------------------------------------------------------- #

def _simulation(pkg):
    sim = pkg.sim
    field, lons, lats = sim.synthetic_ssh_field(n=120, seed=0)
    return {
        "field 300": sim.synthetic_ssh_field(n=300, seed=1),
        "field extent": sim.synthetic_ssh_field(n=96, extent=pkg.gulf.DEFAULT_EXTENT, seed=7),
        "track": sim.generate_track(field, lons, lats, trajectory_gradient=2,
                                    track_sparsity=2.0, observation_sparsity=0),
        "track sparse": sim.generate_track(field, lons, lats, 2, 2.0, 5),
        "track degree range": sim.generate_track(field, lons, lats, 1, 1.5, 0,
                                                 degree_range=8.0),
        "file name": sim.sim_file_name("2012", "10", "01"),
    }


def _track_too_dense(pkg):
    field, lons, lats = pkg.sim.synthetic_ssh_field(n=60)
    return pkg.sim.generate_track(field, lons, lats, 1, 0.0, 0)


def _track_too_sparse(pkg):
    field, lons, lats = pkg.sim.synthetic_ssh_field(n=60)
    return pkg.sim.generate_track(field, lons, lats, 1, 11.0, 0)


def _synthetic_gulfstream(pkg):
    ds = pkg.data.SyntheticGulfStream(seed=4, n=240)
    other = pkg.data.SyntheticGulfStream("jason1", seed=2, n=120, trajectory_gradient=1,
                                         track_sparsity=1.5, noise_std=0.02)
    return {"obs": ds.obs_train_data(3), "obs all": ds.obs_train_data(0),
            "average": ds.grid_ref_data_average(12), "trapz": ds.grid_ref_data_trapz(12),
            "simpson": ds.grid_ref_data_simpson(12), "other": other.grid_ref_data_average(6),
            "other obs": other.obs_train_data(2), "ref": ds._ref_field()}


def _bad_satellite(pkg):
    return pkg.data.SyntheticGulfStream("no-such-satellite")


def _simulation_missing_file(pkg, root):
    return pkg.sim.SimulationDataDay(str(root), "2012", "10", "01")


@pytest.mark.parametrize("scenario", [_simulation, _track_too_dense, _track_too_sparse,
                                      _synthetic_gulfstream, _bad_satellite],
                         ids=["fields and tracks", "too dense", "too sparse",
                              "synthetic gulf stream", "bad satellite"])
def test_simulation_and_synthetic_match(scenario):
    _both(scenario)


def test_simulation_loaders_match(tmp_path, xarray_stub):
    """SimulationDataDay and SimulationDataHour (its track generator too)
    through the stub; a missing file and a bad hour raise alike."""
    field = np.stack([jsim.synthetic_ssh_field(n=48, seed=s)[0] for s in (0, 1, 2)])
    _, lons, lats = jsim.synthetic_ssh_field(n=48, seed=0)
    p = tmp_path / jsim.sim_file_name("2012", "10", "02")
    p.write_bytes(b"")
    xarray_stub[str(p)] = _FakeDataset(data_vars={
        "sossheig": _FakeVar(field, dims=("time", "lat", "lon")),
        "lon": _FakeVar(lons, dims=("lon",)), "lat": _FakeVar(lats, dims=("lat",))})

    def loaders(pkg):
        day = pkg.sim.SimulationDataDay(str(tmp_path), "2012", "10", "02")
        hour = pkg.sim.SimulationDataHour(str(tmp_path), "2012", "10", "02", 1)
        return {"day": np.asarray(day.data.sossheig.values), "name": day.simulation_name,
                "path": day.simulation_file_path, "hour": np.asarray(hour.data.sossheig.values),
                "track": hour.generate_track(2, 2.0, 3)}

    def bad_hour(pkg):
        return pkg.sim.SimulationDataHour(str(tmp_path), "2012", "10", "02", 24)

    _both(loaders)
    _both(bad_hour)
    _both(_simulation_missing_file, tmp_path)


def test_gulfstream_real_loader_match(tmp_path, xarray_stub):
    """GulfStream's window cut and pooled NATL60 mean through the stub, on
    tests/test_xarray_adapters.py's archive (a missing day included), and on
    archives built from a synthetic field and track, whose outputs must also
    equal the synthetic stand-in's."""
    obs_root, ref_root = tmp_path / "obs", tmp_path / "ref"
    obs_root.mkdir()
    ref_root.mkdir()
    t = np.array(["2020-01-02T23:59:59", "2020-01-03T00:00:00", "2020-01-03T12:00:00",
                  "2020-01-04T22:59:00", "2020-01-05T00:00:00", "2020-01-05T23:30:00"],
                 dtype="datetime64[s]")
    obs_path = obs_root / "2020a_SSH_mapping_NATL60_envisat.nc"
    obs_path.write_bytes(b"")
    xarray_stub[str(obs_path)] = _FakeDataset(data_vars={
        "time": _FakeVar(t), "lon": np.array([299.0, 300.0, 301.0, 302.0, 303.0, 304.0]),
        "lat": np.array([34.0, 35.0, 36.0, 37.0, 38.0, 39.0]),
        "ssh_obs": np.array([9.0, 1.0, 2.0, 3.0, 4.0, 9.0])})
    lons = np.linspace(-65.0, -55.0, 4)
    lats = np.linspace(33.0, 43.0, 4)
    f1 = np.arange(32, dtype=np.float64).reshape(2, 4, 4)
    f1[0, 0, 0] = np.nan
    for day, arr, dims in (("03", f1, ("time", "lat", "lon")),
                           ("04", np.full((4, 4), 2.0), ("lat", "lon"))):
        p = ref_root / jsim.sim_file_name("2020", "01", day)
        p.write_bytes(b"")
        xarray_stub[str(p)] = _FakeDataset(data_vars={
            "sossheig": _FakeVar(arr, dims=dims), "lon": _FakeVar(lons, dims=("lon",)),
            "lat": _FakeVar(lats, dims=("lat",))})

    def small(pkg):
        gs = pkg.gulf.GulfStream(str(obs_root), str(ref_root), "envisat",
                                 year_frame=("2020", "2020"), month_frame=("01", "01"),
                                 day_frame=("03", "05"), hour_frame=("00", "22"))
        return {"obs": gs.obs_train_data(sparsity=0), "ref": gs._ref_field(),
                "average": gs.grid_ref_data_average(2), "trapz": gs.grid_ref_data_trapz(2),
                "simpson": gs.grid_ref_data_simpson(2)}

    got = _both(small)
    np.testing.assert_array_equal(got["obs"][1], [1.0, 2.0, 3.0, 4.0])

    field, flons, flats = jsim.synthetic_ssh_field(n=96, extent=jgulf.DEFAULT_EXTENT, seed=7)
    lon, lat, val = jsim.generate_track(field, flons, flats, 2, 1.0, 0)
    val = val + 0.01 * np.random.default_rng(8).standard_normal(val.shape)
    obs2, ref2 = tmp_path / "obs2", tmp_path / "ref2"
    obs2.mkdir()
    ref2.mkdir()
    n = lon.size
    t0, t1 = np.datetime64("2012-10-01T00:00:00"), np.datetime64("2012-10-10T23:00:00")
    p = obs2 / "2020a_SSH_mapping_NATL60_envisat.nc"
    p.write_bytes(b"")
    xarray_stub[str(p)] = _FakeDataset(data_vars={
        "time": _FakeVar((t0 + ((t1 - t0) / (n - 1)) * np.arange(n)).astype("datetime64[s]")),
        "lon": lon + 360.0, "lat": lat, "ssh_obs": val})
    for day in range(1, 11):
        p = ref2 / jsim.sim_file_name("2012", "10", f"{day:02d}")
        p.write_bytes(b"")
        xarray_stub[str(p)] = _FakeDataset(data_vars={
            "sossheig": _FakeVar(field, dims=("lat", "lon")),
            "lon": _FakeVar(flons, dims=("lon",)), "lat": _FakeVar(flats, dims=("lat",))})

    def synthetic_archive(pkg):
        gs = pkg.gulf.GulfStream(str(obs2), str(ref2), "envisat",
                                 year_frame=("2012", "2012"), month_frame=("10", "10"),
                                 day_frame=("01", "10"), hour_frame=("00", "23"))
        stand_in = pkg.gulf.SyntheticGulfStream(seed=0, n=16)
        stand_in._field, stand_in._lons, stand_in._lats = field, flons, flats
        stand_in._track = (lon, lat, val)
        return {"obs": gs.obs_train_data(sparsity=6), "simpson": gs.grid_ref_data_simpson(20),
                "stand-in obs": stand_in.obs_train_data(sparsity=6),
                "stand-in simpson": stand_in.grid_ref_data_simpson(20)}

    got = _both(synthetic_archive)
    np.testing.assert_allclose(got["obs"][0], got["stand-in obs"][0], atol=1e-12)
    np.testing.assert_allclose(got["simpson"], got["stand-in simpson"], atol=1e-12)


def test_loaders_without_xarray_raise_alike(tmp_path):
    """With no xarray importable, a real-archive loader raises the same
    ImportError in both packages (xarray is imported lazily, at load)."""
    obs_root, ref_root = tmp_path / "obs", tmp_path / "ref"
    obs_root.mkdir()
    ref_root.mkdir()
    (obs_root / "2020a_SSH_mapping_NATL60_envisat.nc").write_bytes(b"")
    p = tmp_path / jsim.sim_file_name("2012", "10", "02")
    p.write_bytes(b"")
    saved = sys.modules.get("xarray")
    sys.modules["xarray"] = None     # makes `import xarray` raise ImportError
    try:
        def gulf(pkg):
            return pkg.gulf.GulfStream(str(obs_root), str(ref_root), "envisat",
                                       ("2020", "2020"), ("01", "01"), ("03", "05"),
                                       ("00", "22"))

        def day(pkg):
            return pkg.sim.SimulationDataDay(str(tmp_path), "2012", "10", "02")

        for scenario in (gulf, day):
            got = _both(scenario)
            assert isinstance(got, ImportError), got
    finally:
        if saved is None:
            del sys.modules["xarray"]
        else:
            sys.modules["xarray"] = saved
