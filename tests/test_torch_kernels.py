"""Parity: the port's kernel wrappers on CPU tensors (their plain PyTorch
versions) against the JAX package's Pallas kernels in interpret mode and
their ``*_ref`` oracles. Exact equality: every output is an id or a bool.

On the card the same wrappers launch the CUDA kernels; ``chip_smoke.py``
holds each kernel bit-equal to its plain version there.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.cache_probe.ops import cache_probe as j_cache_probe
from repro.kernels.cache_probe.ref import cache_probe_ref as j_cache_probe_ref
from repro.kernels.onehop_gather.ops import onehop_gather as j_onehop_gather
from repro.kernels.onehop_gather.ref import onehop_gather_ref as j_onehop_gather_ref
from repro_torch.kernels.cache_probe import ops as t_probe_ops
from repro_torch.kernels.cache_probe.ref import cache_probe_ref
from repro_torch.kernels.onehop_gather import ops as t_gather_ops
from repro_torch.kernels.onehop_gather.ref import onehop_gather_ref


def _probe_world(C, B, probes, seed=2):
    """The ``tests/test_kernels.py`` world: half the keys planted as hits."""
    rng = np.random.default_rng(seed)
    c_tpl = rng.integers(-1, 3, C).astype(np.int32)
    c_root = rng.integers(0, 64, C).astype(np.int32)
    c_fp = rng.integers(0, 2**32, C, dtype=np.uint32)
    c_valid = rng.random(C) < 0.5
    tpl = rng.integers(0, 3, B).astype(np.int32)
    root = rng.integers(0, 64, B).astype(np.int32)
    h = rng.integers(0, 2**32, B, dtype=np.uint32)
    for i in range(0, B, 2):
        s = int(h[i] % C)
        c_tpl[s], c_root[s], c_valid[s] = tpl[i], root[i], True
        c_fp[s] = np.uint32(i * 2654435761 % 2**32)
    fp = np.array([np.uint32(i * 2654435761 % 2**32) for i in range(B)], np.uint32)
    # a duplicate planted later in the same window: the first match wins
    s = int((h[0] + 1) % C)
    c_tpl[s], c_root[s], c_fp[s], c_valid[s] = tpl[0], root[0], fp[0], True
    # padding keys, as the JAX wrapper pads: tpl = -1
    tpl[-1:] = -1
    return c_tpl, c_root, c_fp, c_valid, tpl, root, h, fp


@pytest.mark.parametrize("C,B,probes", [(256, 32, 4), (1024, 64, 8), (1024, 13, 8)])
def test_cache_probe_matches_pallas_and_ref(C, B, probes):
    arrays = _probe_world(C, B, probes)
    jargs = tuple(map(jnp.asarray, arrays))
    # the port keeps h / fp / c_fp as int32 holding the uint32 bits
    targs = tuple(torch.as_tensor(a.view(np.int32) if a.dtype == np.uint32 else a)
                  for a in arrays)
    want_hit, want_slot = j_cache_probe(*jargs, probes=probes, block_b=8)
    ref_hit, ref_slot = j_cache_probe_ref(*jargs, probes=probes)
    before = t_probe_ops.launches
    got_hit, got_slot = t_probe_ops.cache_probe(*targs, probes=probes)
    assert t_probe_ops.launches == before  # CPU tensors never count a launch
    plain_hit, plain_slot = cache_probe_ref(*targs, probes=probes)
    for hit, slot in ((want_hit, want_slot), (ref_hit, ref_slot)):
        np.testing.assert_array_equal(got_hit.numpy(), np.asarray(hit))
        np.testing.assert_array_equal(got_slot.numpy(), np.asarray(slot))
    assert torch.equal(got_hit, plain_hit) and torch.equal(got_slot, plain_slot)
    assert got_slot.dtype == torch.int32 and got_hit.dtype == torch.bool
    assert got_hit.numpy()[:-1:2].all()  # the planted hits are found


def _gather_world(V, E, B, max_deg, seed=0, wild_dst=False):
    rng = np.random.default_rng(seed)
    deg = rng.integers(0, max_deg, V).astype(np.int32)
    start = np.zeros(V, np.int32)
    start[1:] = np.cumsum(deg)[:-1]
    assert int(deg.sum()) <= E
    lo, hi = (-3, V + 4) if wild_dst else (0, V)
    dst = rng.integers(lo, hi, E).astype(np.int32)
    eprop = rng.integers(0, 2, E).astype(np.int32)
    vprop = rng.integers(0, 2, V).astype(np.int32)
    roots = rng.integers(0, V, B).astype(np.int32)
    return start, deg, dst, eprop, vprop, roots


@pytest.mark.parametrize("V,E,B,max_deg,block_b", [
    (64, 1024, 8, 16, 8), (128, 4096, 32, 32, 8), (64, 1024, 13, 16, 13),
])
def test_onehop_gather_matches_pallas_and_ref(V, E, B, max_deg, block_b):
    arrays = _gather_world(V, E, B, max_deg)
    arrays[-1][-3:] = -1  # padding roots read nothing and emit -1/False
    kw = dict(max_deg=max_deg, edge_val=1, leaf_val=0)
    jargs = tuple(map(jnp.asarray, arrays))
    want_l, want_m = j_onehop_gather(*jargs, block_b=block_b, **kw)
    ref_l, ref_m = j_onehop_gather_ref(*jargs, **kw)
    before = t_gather_ops.launches
    got_l, got_m = t_gather_ops.onehop_gather(*map(torch.as_tensor, arrays), **kw)
    assert t_gather_ops.launches == before
    for leaves, mask in ((want_l, want_m), (ref_l, ref_m)):
        np.testing.assert_array_equal(got_m.numpy(), np.asarray(mask))
        np.testing.assert_array_equal(got_l.numpy(), np.asarray(leaves))
    assert not got_m.numpy()[-3:].any() and (got_l.numpy()[-3:] == -1).all()


def test_onehop_gather_index_rules_match_ref():
    """Out-of-range roots and leaves follow jnp's gather (wrap once, clamp),
    the rule the CUDA kernel reproduces."""
    arrays = list(_gather_world(32, 256, 24, 8, seed=4, wild_dst=True))
    arrays[-1][:6] = [-1, -40, 31, 32, 99, -32]
    kw = dict(max_deg=8, edge_val=1, leaf_val=0)
    ref_l, ref_m = j_onehop_gather_ref(*map(jnp.asarray, arrays), **kw)
    got_l, got_m = onehop_gather_ref(*map(torch.as_tensor, arrays), **kw)
    np.testing.assert_array_equal(got_m.numpy(), np.asarray(ref_m))
    np.testing.assert_array_equal(got_l.numpy(), np.asarray(ref_l))


def test_wrappers_refuse_other_devices():
    z = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        t_gather_ops.onehop_gather(z, z, z, z, z, z, max_deg=2, edge_val=1, leaf_val=0)
    with pytest.raises(ValueError):
        t_probe_ops.cache_probe(z, z, z, z, z, z, z, z)


GROUP = 8  # csrc/cache_probe.cu's kGroup: threads a key, one probe slot each


def simulate_cache_probe(c_tpl, c_root, c_fp, c_valid, tpl, root, h, fp, *, probes):
    """``cache_probe_kernel`` step by step: each key's group of GROUP threads
    takes the key's four words from its first four threads, loads one probe
    slot a thread a round (no short-circuit), ballots the matches, and takes
    the lowest set bit, the first match in probe order."""
    C, B = len(c_tpl), len(tpl)
    hit, slot = np.zeros(B, bool), np.full(B, -7, np.int32)
    for i in range(B):
        words = [int(w[i]) for w in (tpl, root, h, fp)]  # threads 0-3, shuffled
        t, r, base, f = words[0], words[1], words[2] & (C - 1), words[3]
        first = -1
        for p0 in range(0, probes, GROUP):
            ballot = 0
            for g in range(GROUP):
                p = p0 + g
                if p < probes:
                    s = (base + p) & (C - 1)
                    ok = (bool(c_valid[s]) & (int(c_tpl[s]) == t) & (int(c_root[s]) == r)
                          & (int(c_fp[s]) == f))
                    ballot |= int(ok) << g
            if ballot:
                low = (ballot & -ballot).bit_length() - 1
                first = (base + p0 + low) & (C - 1)
                break
        hit[i], slot[i] = first >= 0, first
    return hit, slot


def _wrap_world(C=64, B=24, seed=6):
    """Keys whose windows wrap at C. Key 0 matches at slot C-1 (probe 0)
    and at slot 0 (probe 1, wrapped, the lower index): probe order must
    win. Key 1 matches only past the wrap (slot 2, probe 4). Key 2 matches
    nowhere. Key 3's window is its last probe (slot 4, probe 7). The rest
    are random over a half-full cache."""
    rng = np.random.default_rng(seed)
    c_tpl = rng.integers(0, 3, C).astype(np.int32)
    c_root = rng.integers(0, 8, C).astype(np.int32)
    c_fp = rng.integers(0, 2**32, C, dtype=np.uint32)
    c_valid = rng.random(C) < 0.5
    tpl = rng.integers(0, 3, B).astype(np.int32)
    root = rng.integers(0, 8, B).astype(np.int32)
    fp = rng.integers(0, 2**32, B, dtype=np.uint32)
    h = rng.integers(0, 2**32, B, dtype=np.uint32)
    h[:4] = [C - 1, C - 2, C - 3, C - 3]
    c_valid[[C - 3, C - 2, 1, 3]] = False  # clear key 1's earlier probes' slots
    for i, slots in ((0, (C - 1, 0)), (1, (2,)), (3, (4,))):
        for s in slots:
            c_tpl[s], c_root[s], c_fp[s], c_valid[s] = tpl[i], root[i], fp[i], True
    # keys 2 and 3 share a window; key 2 differs in its fingerprint alone
    fp[2] = fp[3] ^ np.uint32(1)
    root[2], tpl[2] = root[3], tpl[3]
    # random keys planted at random slots of their windows, some past the wrap
    for i in range(4, B, 2):
        s = int((h[i] + rng.integers(0, 8)) % C)
        if s in (C - 3, C - 2, C - 1, 0, 1, 2, 3, 4):
            continue  # the four keys' windows stay as planted
        c_tpl[s], c_root[s], c_fp[s], c_valid[s] = tpl[i], root[i], fp[i], True
    return c_tpl, c_root, c_fp, c_valid, tpl, root, h, fp


@pytest.mark.parametrize("probes", [8, 5, 12, 1])
def test_cache_probe_group_simulation_matches_pallas_and_ref(probes):
    arrays = _wrap_world()
    C = len(arrays[0])
    targs = tuple(torch.as_tensor(a.view(np.int32) if a.dtype == np.uint32 else a)
                  for a in arrays)
    got_hit, got_slot = simulate_cache_probe(*(a.numpy() for a in targs), probes=probes)
    plain_hit, plain_slot = cache_probe_ref(*targs, probes=probes)
    jargs = tuple(map(jnp.asarray, arrays))
    pallas = j_cache_probe(*jargs, probes=probes, block_b=8)
    ref = j_cache_probe_ref(*jargs, probes=probes)
    for hit, slot in ((plain_hit, plain_slot), pallas, ref):
        np.testing.assert_array_equal(got_hit, np.asarray(hit))
        np.testing.assert_array_equal(got_slot, np.asarray(slot))
    if probes == 8:
        # probe order, not slot order; a match past the wrap; a miss
        assert got_slot[:4].tolist() == [C - 1, 2, -1, 4]
        assert got_hit[4:].any() and not got_hit[4:].all()
    if probes == 5:  # key 3's only match is its 8th probe, out of reach
        assert got_slot[:4].tolist() == [C - 1, 2, -1, -1]


def test_cache_probe_binding_passes_the_c_arguments(monkeypatch):
    """``cache_probe_cuda`` hands the C entry point the ten pointers, then
    B, C and probes, then the stream, and raises when the launch reports an
    error. The C call is a stand-in: no kernel runs here."""
    from repro_torch.kernels import _build
    from repro_torch.kernels.cache_probe import kernel

    seen, err = [], [0]

    def fake_bind(name, symbol, n_pointers, n_ints):
        assert (name, symbol, n_pointers, n_ints) == ("cache_probe", "cache_probe_launch", 10, 3)
        return lambda *a: seen.append(a) or err[0]

    monkeypatch.setattr(_build, "bind", fake_bind)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: type("S", (), {"cuda_stream": 99})())
    arrays = _probe_world(256, 13, 8)
    t = [torch.as_tensor(a.view(np.int32) if a.dtype == np.uint32 else a) for a in arrays]
    hit, slot = kernel.cache_probe_cuda(*t, probes=5)
    (a,) = seen
    assert a == (*(x.data_ptr() for x in t), hit.data_ptr(), slot.data_ptr(), 13, 256, 5, 99)
    assert hit.shape == slot.shape == (13,) and hit.dtype == torch.bool and slot.dtype == torch.int32
    err[0] = 700
    with pytest.raises(RuntimeError, match="cudaError 700"):
        kernel.cache_probe_cuda(*t, probes=8)


def test_build_digest_covers_the_shared_headers(tmp_path, monkeypatch):
    """The build directory's digest hashes the headers the sources share
    (``csrc/*.cuh``), so an edited header rebuilds every library instead of
    reusing a stale one; a header is never compiled on its own."""
    from repro_torch.kernels import _build

    monkeypatch.setattr(_build, "SRC_DIR", tmp_path)
    (tmp_path / "a.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("// one\n")
    first = _build.build_dir()
    assert _build.sources() == [tmp_path / "a.cu"] and _build.headers() == [tmp_path / "h.cuh"]
    assert _build.build_dir() == first
    (tmp_path / "h.cuh").write_text("// two\n")
    second = _build.build_dir()
    assert second != first
    (tmp_path / "b.cuh").write_text("// a new header\n")
    assert _build.build_dir() not in (first, second)


def test_attention_sources_share_the_hopper_header():
    """Both attention sources take their PTX wrappers and tensor maps from
    ``csrc/hopper.cuh``, which the build digest covers."""
    from repro_torch.kernels import _build

    assert _build.SRC_DIR / "hopper.cuh" in _build.headers()
    for src in ("flash_attention.cu", "flash_attention_bwd.cu"):
        assert '#include "hopper.cuh"' in (_build.SRC_DIR / src).read_text()
