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
