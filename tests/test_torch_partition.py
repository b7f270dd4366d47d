"""Parity: the port's partitioned store, ``block_gather`` (plain version on
the CPU), per-shard ``block_onehop_exec`` and the wire format against the
JAX package. Exact equality: every output is an id, a mask or a count.

The store is the ``conftest`` world after one single-host mutation batch,
so the blocks' recent regions are live.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as J
from conftest import build_world, sq1_hop, sq2_hop
from repro.core.keys import PARAM_LEN
from repro.core.runtime import bucketize as j_bucketize
from repro.core.runtime import pack_query_frame as j_pack_query
from repro.core.runtime import pack_result_frame as j_pack_result
from repro.core.runtime import route_plan as j_route_plan
from repro.distributed.routing import identity_table as j_identity_table
from repro.graphstore import make_mutation_batch as j_batch
from repro.graphstore import partition as JP
from repro.graphstore.mutations import apply_mutations as j_apply
from repro.kernels.block_gather.ops import block_onehop_exec as j_block_exec
from repro.kernels.block_gather.ref import block_gather_filter_ref as j_bg_ref
from repro_torch import interop
from repro_torch.core import runtime as TR
from repro_torch.core.templates import DIR_BOTH, DIR_IN, DIR_OUT
from repro_torch.distributed.routing import base_owner, identity_table
from repro_torch.graphstore import partition as TP
from repro_torch.kernels.block_gather import ops as bg_ops
from repro_torch.kernels.block_gather.ref import block_gather_filter_ref
from test_kernels import _PRED_CASES, _block_gather_world

N = 4


def to_np(x):
    if hasattr(x, "_asdict"):
        return {k: to_np(v) for k, v in x._asdict().items()}
    if isinstance(x, torch.Tensor):
        return x.numpy()
    return np.asarray(x)


def assert_tree_equal(got, want, path=""):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            assert_tree_equal(got[k], want[k], f"{path}.{k}")
    else:
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)


@pytest.fixture(scope="module")
def pw():
    spec, store = build_world()
    mb = j_batch(
        spec, new_vertices=[(1, [0, 1007])],
        new_edges=[(0, 11, 0, [1]), (2, 16, 0, [0]), (3, 5, 0, [1])],
        del_edges=[2, 5], del_vertices=[9],
        set_vprops=[(7, 0, 1), (8, 0, 0), (12, 1, 4242)], set_eprops=[(1, 0, 0), (4, 0, 1)],
    )
    store2, _ = jax.jit(j_apply, static_argnums=0)(spec, store, mb)
    jspec = J.EngineSpec(store=spec, cache=J.CacheSpec(capacity=1024, probes=8, max_leaves=16,
                                                        max_chunks=2), max_deg=32, frontier=32)
    jpspec = JP.default_pspec(spec, N)
    tstore = interop.store_from_numpy(to_np(store2), device="cpu")
    tpspec = TP.default_pspec(interop.store_spec(tuple(spec)), N)
    return dict(
        jspec=jspec, tspec=interop.engine_spec(tuple(spec), tuple(jspec.cache), 32, 32),
        jpspec=jpspec, tpspec=tpspec, jps=JP.partition_store(jpspec, store2),
        jstore=store2, tstore=tstore,
        tps=TP.partition_store(tpspec, tstore),
    )


def test_partition_store_matches_jax(pw):
    assert tuple(pw["tpspec"]) == tuple(pw["jpspec"])
    jps, tps = pw["jps"], pw["tps"]
    # the mutation batch appended past csr_len: the recent regions are live
    assert int(jps.e_len) > int(jps.out.csr_len.sum())
    assert any((np.asarray(b.blk_len) > np.asarray(b.csr_len)).any() for b in (jps.out, jps.inc))
    assert_tree_equal(interop.pstore_to_numpy(tps), to_np(jps))
    # a shard's tensors are views of the global layout, not copies
    loc = TP.local_shard(pw["tpspec"], tps, 2)
    assert loc.out.key.data_ptr() == tps.out.key[2 * pw["tpspec"].e_blk_cap:].data_ptr()
    # the round trip through numpy is exact
    back = interop.pstore_from_numpy(to_np(jps), device="cpu")
    assert_tree_equal(interop.pstore_to_numpy(back), to_np(jps))


def test_block_capacity_error_names_the_need(pw):
    """A block too small for its owner's edges raises with the count it
    needs, as the reference's ``_build_block`` does."""
    tiny_t = pw["tpspec"]._replace(e_blk_cap=8)
    tiny_j = pw["jpspec"]._replace(e_blk_cap=8)
    with pytest.raises(TP.BlockCapacityError) as got:
        TP.partition_store(tiny_t, pw["tstore"])
    with pytest.raises(JP.BlockCapacityError) as want:
        JP.partition_store(tiny_j, pw["jstore"])
    assert got.value.needed == want.value.needed > 8


def test_store_bytes_report_matches_jax(pw):
    assert TP.store_bytes_report(pw["tpspec"], pw["tps"]) == \
        JP.store_bytes_report(pw["jpspec"], pw["jps"])


_j_bg_ref = jax.jit(j_bg_ref, static_argnames=(
    "max_deg", "recent_cap", "e_blk_cap", "edge_label", "pe", "pl"))


def _torch_args(args):
    return tuple(torch.as_tensor(np.array(a)) for a in args)


@pytest.mark.parametrize("B", [0, 1, 16])
@pytest.mark.parametrize("edge_label,pe,pl", _PRED_CASES)
def test_block_gather_plain_matches_jax(B, edge_label, pe, pl):
    rng = np.random.default_rng(B * 7 + len(pe[1]))
    args, statics = _block_gather_world(rng, max(B, 1))
    # rows 11.. are per-row inputs; B = 0 keeps none of them
    args = list(args[:11]) + [a[:B] for a in args[11:]]
    # split gate: half the rows lose the CSR window (cvalid != rvalid)
    args[14] = args[13] & jnp.asarray(np.arange(B) % 2 == 0)
    statics.update(edge_label=edge_label, pe=pe, pl=pl)
    want = _j_bg_ref(*args, **statics)
    targs = _torch_args(args)
    before = bg_ops.launches
    got = bg_ops.block_gather(*targs, **statics)
    assert bg_ops.launches == before  # CPU tensors never count a launch
    plain = block_gather_filter_ref(*targs, **statics)
    for name, g, p, w in zip(("leaf", "scan", "emask", "qual", "trunc"), got, plain, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
        assert torch.equal(g, p), name


@pytest.mark.parametrize("direction", [DIR_OUT, DIR_IN, DIR_BOTH])
def test_block_onehop_exec_per_shard_matches_jax(pw, direction):
    jspec, tspec = pw["jspec"], pw["tspec"]
    jpspec, tpspec = pw["jpspec"], pw["tpspec"]
    hop = sq1_hop() if direction != DIR_IN else sq2_hop()
    thop = interop.hop_from_numpy(to_np(hop))
    roots = np.array([0, 1, 2, 3, 5, 9, 11, 16, 63, -1, 64], np.int32)
    params = np.broadcast_to(np.asarray(hop.params, np.int32), (len(roots), PARAM_LEN))
    jt, tt = j_identity_table(N), identity_table(N, device="cpu")

    @jax.jit  # one compile for every shard: the shard index is traced
    def j_exec(local, me, rmask):
        view = JP.BlockStoreView(jpspec, local, me, rtable=jt)
        return j_block_exec(jspec, view, direction, hop.edge_label, hop.pr, hop.pe, hop.pl,
                            jnp.asarray(roots), jnp.asarray(params), rmask, use_pallas=False)

    @functools.partial(jax.jit, static_argnums=2)
    def j_adjacency(local, me, incoming):
        view = JP.BlockStoreView(jpspec, local, me, rtable=jt)
        return view.adjacency(jnp.asarray(roots), jspec.max_deg, incoming=incoming)

    for s in range(N):
        rmask = np.array([True] * 9 + [False, True]) & (base_owner(roots, N) == s)
        jview = JP.BlockStoreView(jpspec, JP.local_shard(jpspec, pw["jps"], s), s, rtable=jt)
        tview = TP.BlockStoreView(tpspec, TP.local_shard(tpspec, pw["tps"], s), s, rtable=tt)
        want = j_exec(jview.ps, s, jnp.asarray(rmask))
        got = bg_ops.block_onehop_exec(
            tspec, tview, direction, thop.edge_label, thop.pr, thop.pe, thop.pl,
            torch.as_tensor(roots), torch.as_tensor(params.copy()), torch.as_tensor(rmask))
        for name, g, w in zip(("leaves", "lmask", "n_true", "trunc"), got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{s}.{name}")
        for k in ("edges_scanned", "leaf_fetches", "scanned", "scanned_mask"):
            np.testing.assert_array_equal(got[4][k].numpy(), np.asarray(want[4][k]),
                                          err_msg=f"{s}.{k}")
        # the plain per-view gather CP executes through
        for incoming in (False, True):
            got_a = tview.adjacency(torch.as_tensor(roots), tspec.max_deg, incoming=incoming)
            want_a = j_adjacency(jview.ps, s, incoming)
            for g, w in zip(got_a, want_a):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=f"{s}.adjacency")


def test_wire_frames_and_bucketize_match_jax():
    rng = np.random.default_rng(3)
    n, cap, m = 4, 5, 32
    roots = rng.integers(-1, 1 << 20, m).astype(np.int32)
    flags = rng.integers(0, 2, m).astype(np.int32)
    params = rng.integers(-(1 << 15), 1 << 15, (m, PARAM_LEN)).astype(np.int32)
    # -1 rows are padding; peer 2 gets more than cap rows, so some drop
    dest = np.where(rng.random(m) < 0.4, 2, rng.integers(-1, n, m)).astype(np.int32)
    jf = j_pack_query(jnp.asarray(roots), jnp.asarray(flags), jnp.asarray(params))
    tf = TR.pack_query_frame(torch.as_tensor(roots), torch.as_tensor(flags), torch.as_tensor(params))
    assert tf.shape == (m, TR.WIRE_QUERY_LANES)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    for g, w in zip(TR.unpack_query_frame(tf), (roots, flags, params)):
        np.testing.assert_array_equal(g.numpy(), w)
    jb = j_bucketize(jf, jnp.asarray(dest), n, cap, fill=0)
    tb = TR.bucketize(tf, torch.as_tensor(dest), n, cap, fill=0)
    assert int(tb[3]) > 0
    for name, g, w in zip(("buckets", "slot", "kept", "overflow"), tb, jb):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    for g, w in zip(TR.route_plan(torch.as_tensor(dest), n, 64), j_route_plan(jnp.asarray(dest), n, 64)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    vals = rng.integers(-1, 100, (m, 8)).astype(np.int32)
    cnt = rng.integers(-1, 9, m).astype(np.int32)
    jr = j_pack_result(jnp.asarray(vals), jnp.asarray(cnt))
    tr = TR.pack_result_frame(torch.as_tensor(vals), torch.as_tensor(cnt))
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
    for g, w in zip(TR.unpack_result_frame(tr), (vals, cnt)):
        np.testing.assert_array_equal(g.numpy(), w)
