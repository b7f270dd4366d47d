"""The port's observability tier (``repro_torch.obs``) against the
reference's (``repro.obs``) on the same numpy inputs: histogram quantiles,
percentiles, merge and dict form; the owner-stage helpers; each package's
trace validator on the other's ``ServeTelemetry`` stream; and the same
malformed events rejected by both with the same message."""

import json

import numpy as np
import pytest

import repro.obs.histogram as ref_hist
import repro.obs.metrics as ref_metrics
import repro.obs.schema as ref_schema
import repro.obs.telemetry as ref_tel
import repro.obs.validate as ref_validate
import repro_torch.obs.histogram as port_hist
import repro_torch.obs.metrics as port_metrics
import repro_torch.obs.schema as port_schema
import repro_torch.obs.telemetry as port_tel
import repro_torch.obs.validate as port_validate
from test_torch_fixtures import _torch_test_env  # noqa: F401


PACKAGES = {"reference": (ref_hist, ref_metrics, ref_schema, ref_tel, ref_validate),
            "port": (port_hist, port_metrics, port_schema, port_tel, port_validate)}
QS = (0.0, 0.001, 0.25, 0.5, 0.9, 0.95, 0.99, 0.999, 1.0)


def _sample_sets():
    rng = np.random.default_rng(0)
    h = port_hist.LatencyHistogram()
    edges = h.lo * 10.0 ** (np.arange(0, h.n_buckets + 1) / h.buckets_per_decade)
    return {
        "empty": (np.zeros(0), None),
        "lognormal": (rng.lognormal(-6.0, 1.0, 500), None),
        "weighted": (rng.lognormal(-4.0, 2.0, 64), rng.integers(0, 9, 64)),
        # every bucket edge, and a hair either side of it
        "bucket_edges": (np.concatenate([edges, edges * (1 + 1e-12), edges * (1 - 1e-12)]),
                         None),
        "out_of_range": (np.array([0.0, 1e-12, 1e-7, 99.999, 1e2, 1e3, 1e9]),
                         np.array([1, 2, 3, 4, 5, 6, 7])),
    }


SAMPLES = _sample_sets()


def _hist(pkg, samples, weights, one_by_one=False):
    h = PACKAGES[pkg][0].LatencyHistogram()
    if one_by_one:
        ws = np.ones(len(samples), np.int64) if weights is None else weights
        for s, w in zip(samples, ws):
            h.record(float(s), weight=int(w))
    else:
        h.record_many(samples, weights)
    return h


def _read(h):
    return ([h.quantile(q) for q in QS] if h.count else [],
            h.percentiles(), h.to_dict(), h.count)


def _same(a, b):
    """Equal, reading NaN as equal to NaN."""
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


@pytest.mark.parametrize("name", list(SAMPLES))
def test_histogram_reads_equal(name):
    samples, weights = SAMPLES[name]
    for one_by_one in (False, True):
        ref = _hist("reference", samples, weights, one_by_one)
        port = _hist("port", samples, weights, one_by_one)
        assert _same(_read(port), _read(ref))


@pytest.mark.parametrize("name", list(SAMPLES))
def test_histogram_merge_and_dicts_cross_load(name):
    samples, weights = SAMPLES[name]
    other, ow = SAMPLES["lognormal"]
    merged = {pkg: _hist(pkg, samples, weights).merge(_hist(pkg, other, ow))
              for pkg in PACKAGES}
    assert _same(_read(merged["port"]), _read(merged["reference"]))
    inplace = _hist("port", samples, weights).merge_in(_hist("port", other, ow))
    assert _same(_read(inplace), _read(merged["reference"]))
    # each package's dict loads in the other and reads the same
    for a, b in (("port", "reference"), ("reference", "port")):
        back = PACKAGES[b][0].LatencyHistogram.from_dict(merged[a].to_dict())
        assert _same(_read(back), _read(merged[a]))
    with pytest.raises(ValueError, match="bucket specs"):
        merged["port"].merge(port_hist.LatencyHistogram(buckets_per_decade=8))


def _matrices():
    n, S = 4, len(port_metrics.OWNER_STAGE_FIELDS)
    rng = np.random.default_rng(1)
    balanced = np.tile(rng.integers(1, 50, (1, S)), (n, 1))
    skewed = rng.integers(0, 50, (n, S))
    skewed[2] *= 40
    return {"balanced": balanced, "skewed": skewed, "all_zero": np.zeros((n, S), np.int64),
            "one_owner": rng.integers(0, 9, (1, S))}


MATRICES = _matrices()


@pytest.mark.parametrize("name", list(MATRICES))
def test_owner_stage_helpers_equal(name):
    m = MATRICES[name]
    assert port_metrics.OWNER_STAGE_FIELDS == ref_metrics.OWNER_STAGE_FIELDS
    assert port_metrics.WORK_FIELDS == ref_metrics.WORK_FIELDS
    assert port_metrics.owner_stage_rows(m) == ref_metrics.owner_stage_rows(m)
    for fn in ("hit_locality", "owner_load_share"):
        np.testing.assert_array_equal(getattr(port_metrics, fn)(m), getattr(ref_metrics, fn)(m))
    for secs in (0.0, 0.0125, 3.5):
        np.testing.assert_array_equal(port_metrics.attribute_step_seconds(secs, m),
                                      ref_metrics.attribute_step_seconds(secs, m))
    with pytest.raises(ValueError, match="owner_stage must be"):
        port_metrics.hit_locality(m[:, :-1])


def _stream(pkg, path, n=4):
    """A ServeTelemetry stream of one package over seeded inputs; returns
    its events."""
    tel = PACKAGES[pkg][3].ServeTelemetry(n, trace_path=str(path))
    rng = np.random.default_rng(2)
    with tel.tracer.span("checkpoint"):  # a span before the first batch
        pass
    for b in range(6):
        stage = rng.integers(0, 50, (n, len(port_metrics.OWNER_STAGE_FIELDS)))
        tel.record_gr(float(rng.uniform(1e-4, 1e-1)),
                      {"hits": int(stage[:, 1].sum()), "misses": int(stage[:, 2].sum()),
                       "requests": 7, "host_syncs": 3}, owner_stage=stage)
        tel.tracer.record("gr_dispatch", float(rng.uniform(1e-4, 1e-2)))
        tel.record_grw(float(rng.uniform(1e-3, 1.0)))
        tel.record_cp_drain(float(rng.uniform(1e-4, 1e-2)))
        tel.bump("commits")
        if b % 2 == 1:
            tel.snapshot(b)
    tel.record_gr(0.01, {"hits": 0, "misses": 0})  # a batch without the block
    tel.report()
    tel.close()
    return [json.loads(line) for line in open(path)]


def test_validators_accept_each_others_stream(tmp_path):
    events = {pkg: _stream(pkg, tmp_path / f"{pkg}.jsonl") for pkg in PACKAGES}
    for reader in PACKAGES.values():
        for pkg in PACKAGES:
            counts = reader[4].validate_file(str(tmp_path / f"{pkg}.jsonl"),
                                             expect_snapshots=3, expect_report=True)
            assert counts == {"meta": 1, "span": 7, "snapshot": 3, "report": 1}
            assert reader[4].main([str(tmp_path / f"{pkg}.jsonl"), "--expect-report"]) == 0

    def drop_times(ev):
        ev = {k: v for k, v in ev.items() if k != "ts"}
        for k in ("spans",):
            if k in ev:
                ev[k] = {n: {"count": a["count"]} for n, a in ev[k].items()}
        return ev

    # the same inputs make the same events, but for wall-clock fields
    same = [drop_times(e) for e in events["port"] if e["type"] != "span"]
    assert same == [drop_times(e) for e in events["reference"] if e["type"] != "span"]


def _snapshot(pkg, n=3):
    tel = PACKAGES[pkg][3].ServeTelemetry(n)
    tel.record_gr(0.01, {"hits": 2, "misses": 1},
                  owner_stage=np.ones((n, len(port_metrics.OWNER_STAGE_FIELDS)), np.int64))
    return tel.snapshot(0)


def _meta():
    return {"type": "meta", "version": port_schema.SCHEMA_VERSION, "shards": 3,
            "stage_fields": list(port_metrics.OWNER_STAGE_FIELDS), "ts": 1.0}


def _edit(ev, path, value):
    *head, last = path
    d = ev
    for k in head:
        d = d[k]
    if value is _DELETE:
        del d[last]
    else:
        d[last] = value
    return ev


_DELETE = object()
# (name, event factory, shards) -> both packages raise ValueError alike
EVENT_CASES = {
    "unknown_type": (lambda pkg: {"type": "bogus"}, None),
    "not_an_object": (lambda pkg: ["meta"], None),
    "owner_rows_short": (lambda pkg: _edit(_snapshot(pkg), ["owner_stage"],
                                           _snapshot(pkg)["owner_stage"][:-1]), 3),
    "negative_counter": (lambda pkg: _edit(_snapshot(pkg), ["owner_stage", 0, "probe_hits"], -1),
                         3),
    "bool_counter": (lambda pkg: _edit(_snapshot(pkg), ["owner_stage", 1, "miss_rows"], True),
                     3),
    "missing_field": (lambda pkg: _edit(_snapshot(pkg), ["owner_stage", 2, "deferred_rows"],
                                        _DELETE), 3),
    "locality_out_of_range": (lambda pkg: _edit(_snapshot(pkg), ["hit_locality", 0], 1.5), 3),
    "missing_class": (lambda pkg: _edit(_snapshot(pkg), ["latency", "grw"], _DELETE), 3),
    "negative_latency": (lambda pkg: _edit(_snapshot(pkg), ["latency", "gr_cached", "p50"],
                                           -0.5), 3),
    "negative_batch": (lambda pkg: _edit(_snapshot(pkg), ["batch"], -1), 3),
    "span_aggregate_count": (lambda pkg: _edit(_snapshot(pkg), ["spans"],
                                               {"x": {"count": 1.5, "total_s": 0.1}}), 3),
    "meta_version": (lambda pkg: _edit(_meta(), ["version"], 2), None),
    "meta_fields": (lambda pkg: _edit(_meta(), ["stage_fields"],
                                      list(port_metrics.OWNER_STAGE_FIELDS)[::-1]), None),
    "meta_no_shards": (lambda pkg: _edit(_meta(), ["shards"], 0), None),
    "span_negative": (lambda pkg: {"type": "span", "name": "x", "dur_s": -1.0, "ts": 1.0},
                      None),
    "span_empty_name": (lambda pkg: {"type": "span", "name": "", "dur_s": 1.0, "ts": 1.0},
                        None),
    "span_attrs": (lambda pkg: {"type": "span", "name": "x", "dur_s": 1.0, "ts": 1.0,
                                "attrs": [1]}, None),
    "report_no_counters": (lambda pkg: _edit(dict(_snapshot(pkg), type="report", batches=1),
                                             ["batch"], _DELETE), 3),
}
# (name, trace lines) -> both packages' validate_file raise alike
FILE_CASES = {
    "span_before_meta": ['{"type":"span","name":"x","dur_s":0.1,"ts":1.0}'],
    "empty": [],
    "not_json": [json.dumps(_meta()), "{oops"],
    "duplicate_meta": [json.dumps(_meta()), json.dumps(_meta())],
    "no_report": [json.dumps(_meta())],
}


@pytest.mark.parametrize("case", list(EVENT_CASES) + [f"file:{k}" for k in FILE_CASES])
def test_both_reject_the_same_malformed_events(case, tmp_path):
    errors = {}
    for pkg, (_, _, schema, _, validate) in PACKAGES.items():
        with pytest.raises(ValueError) as e:
            if case.startswith("file:"):
                path = tmp_path / f"{pkg}.jsonl"
                path.write_text("".join(line + "\n" for line in FILE_CASES[case[5:]]))
                validate.validate_file(str(path), expect_report=True)
            else:
                make, shards = EVENT_CASES[case]
                schema.validate_event(make(pkg), shards=shards)
        errors[pkg] = str(e.value).replace(str(tmp_path / pkg), "PATH")
    assert errors["port"] == errors["reference"]
