"""Port parity: position-striped (sp) paged serving against the JAX
package's.

K2's striped variant (``pos_map`` + ``return_stats``) runs here through
its plain version (the wrapper takes it only because the tensors lie on
the CPU) against the JAX Pallas kernel in interpret mode
(``default_interpret()``); the striped read, the striped batcher and its
allocator against the JAX ones on the conftest's 8 CPU devices
(``make_mesh({"sp": n})``), the port's mesh being its CPU device
repeated; the server under ``sp=2``.  The JAX batcher compared with is
its ``"xla"`` striped one, bit-identical to its unstriped batcher
(``tests/test_sp_stripe.py``) and quick, where the interpreted striped
Pallas batcher is slow."""

import dataclasses
import functools
import importlib
import json
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpushare.models import transformer as jtf
from tpushare.ops import quant as jq
from tpushare.parallel.mesh import make_mesh as jax_mesh
from tpushare.serving.paged import PagedContinuousBatcher as JaxPaged
from tpushare_torch.models import transformer as ttf
from tpushare_torch.models.bridge import params_from_numpy
from tpushare_torch.ops import attention as tattn
from tpushare_torch.ops import quant as tq
from tpushare_torch.parallel import mesh as tmesh
from tpushare_torch.serving.llm import LLMServer, build_model
from tpushare_torch.serving.paged import PagedContinuousBatcher

# tiny shapes: one intra-op thread, so this file does not crowd the
# wall-clock tests that other workers run beside it
torch.set_num_threads(1)

# the JAX package's ops/__init__ re-exports a function named attention
jattn = importlib.import_module("tpushare.ops.attention")

#: the striped plain version against the interpreted Pallas kernel, and
#: the striped read against JAX's, f32: reassociated sums only
ATOL = 2e-5
#: the striped read against the unstriped one: the merge's reassociation
MERGE_ATOL = 1e-5

CPU = torch.device("cpu")
CFG = jtf.tiny(max_seq=96)
PROMPTS = [[5, 9, 2], [11, 3], [1, 2, 3, 4, 5]]


def port_mesh(sp):
    return tmesh.make_mesh({"sp": sp}, devices=[CPU] * sp)


def _striped_table(rng, contexts, sp, per, page, n_tbl):
    """A global table laid out as the batcher lays it: range j of a row
    from stripe j % sp, never a stripe's trash page s*per."""
    free = [list(rng.permutation(np.arange(t * per + 1, (t + 1) * per)))
            for t in range(sp)]
    table = np.zeros((len(contexts), n_tbl), np.int32)
    for i, c in enumerate(contexts):
        for j in range(-(-c // page)):
            table[i, j] = free[j % sp].pop()
    return table


# ---------------------------------------------------------------------------
# the local view and K2's striped variant
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("sp", [2, 4])
def test_striped_local_view_matches_jax(sp):
    """Local tables and pos_maps equal the JAX function's integers,
    unreserved entries and (n_tbl = 7 splits unevenly) past-the-table
    entries included: local trash page 0, positions past the table."""
    per, page, n_tbl = 9, 8, 7
    table = _striped_table(np.random.default_rng(sp), [5, 30, 56], sp, per,
                           page, n_tbl)
    for shard in range(sp):
        jt, jp = jattn.striped_local_view(jnp.asarray(table), sp, shard,
                                          per, page)
        tt, tp = tattn.striped_local_view(torch.from_numpy(table), sp,
                                          shard, per, page)
        assert tt.dtype == tp.dtype == torch.int32
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert tp[-1].item() >= n_tbl * page


def _stores(rng, int8, per, hkv, page, d):
    out = []
    for _ in range(2):
        x = rng.standard_normal((per, hkv, page, d)).astype(np.float32)
        if int8:
            out.append((jq.quantize_kv(jnp.asarray(x)),
                        tq.quantize_kv(torch.from_numpy(x))))
        else:
            out.append((jnp.asarray(x), torch.from_numpy(x)))
    return out


#: (s, window, int8): decode and 4-row prefill windows, with and without
#: a sliding window, each on both stores; the first context (5) ends
#: before stripe 1's first position (8), so its rows keep no key there
STRIPED_CASES = [(1, None, False), (1, 16, True), (4, None, True),
                 (4, 8, False)]


@pytest.mark.parametrize("s,window,int8", STRIPED_CASES)
def test_k2_striped_plain_matches_the_pallas_kernel(s, window, int8):
    """out, m and l of K2's striped plain version within 2e-5 of the
    interpreted Pallas kernel on each stripe's local table and pos_map;
    rows that see nothing of a stripe return out 0, m NEG_INF and l 0 in
    both."""
    b, hkv, n_rep, d, page, sp, per, n_tbl = 3, 2, 2, 32, 8, 2, 12, 7
    rng = np.random.default_rng(s * 10 + (window or 0) + int8)
    contexts = [5, 30, 50]
    table = _striped_table(rng, contexts, sp, per, page, n_tbl)
    pos = np.stack([np.arange(c - s, c) for c in contexts]).astype(np.int32)
    q = rng.standard_normal((b, hkv * n_rep, s, d)).astype(np.float32)
    empty = 0
    for shard in range(sp):
        (jk, tk), (jv, tv) = _stores(rng, int8, per, hkv, page, d)
        jt, jp = jattn.striped_local_view(jnp.asarray(table), sp, shard,
                                          per, page)
        want = jattn.paged_decode_attention(
            jnp.asarray(q), jk, jv, jt, jnp.asarray(pos), window=window,
            pos_map=jp, return_stats=True)
        tt, tp = tattn.striped_local_view(torch.from_numpy(table), sp,
                                          shard, per, page)
        got = tattn.paged_decode_attention(
            torch.from_numpy(q), tk, tv, tt, torch.from_numpy(pos),
            window=window, pos_map=tp, return_stats=True)
        for g, w in zip(got, want):
            assert torch.isfinite(g).all()
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                       rtol=0)
        _, m, l = got
        none = l == 0
        assert (m[none] == tattn.NEG_INF).all()
        assert (got[0][none] == 0).all()
        empty += int(none.sum())
    assert empty > 0


def test_k2_striped_wrapper_validates():
    q = torch.zeros(1, 4, 1, 32)
    pool = torch.zeros(3, 2, 8, 32)
    table = torch.zeros(1, 2, dtype=torch.int32)
    with pytest.raises(ValueError, match="pos_map"):
        tattn.paged_decode_attention(q, pool, pool, table,
                                     torch.zeros(1, 1, dtype=torch.int32),
                                     pos_map=torch.zeros(3, dtype=torch.int32),
                                     return_stats=True)


@pytest.mark.parametrize("sp,s,window,int8", [(2, 1, None, False),
                                              (4, 1, None, True),
                                              (2, 4, 8, True),
                                              (4, 4, None, False)])
def test_sp_striped_read_matches_jax_and_the_unstriped_read(sp, s, window,
                                                           int8):
    """``sp_striped_paged_decode_attention`` over stripes of a pool
    (``shard_kv_storage``) within 2e-5 of JAX's under ``shard_map`` (the
    interpreted kernel per shard, ``sp_merge_partials``), and within 1e-5
    of the unstriped read of the same pool."""
    b, hkv, n_rep, d, page, per, n_tbl = 3, 2, 2, 32, 8, 10, 8
    rng = np.random.default_rng(sp * 100 + s)
    contexts = [5, 30, 61]
    table = _striped_table(rng, contexts, sp, per, page, n_tbl)
    pos = np.stack([np.arange(c - s, c) for c in contexts]).astype(np.int32)
    q = rng.standard_normal((b, hkv * n_rep, s, d)).astype(np.float32)
    (jk, tk), (jv, tv) = _stores(rng, int8, sp * per, hkv, page, d)
    want = jattn.sp_striped_paged_decode_attention(
        jnp.asarray(q), jk, jv, jnp.asarray(table), jnp.asarray(pos),
        jax_mesh({"sp": sp}), window=window)
    mesh = port_mesh(sp)

    def stacked(store):
        return ({k: v[None] for k, v in store.items()}
                if isinstance(store, dict) else store[None])

    stripes = tmesh.shard_kv_storage((stacked(tk), stacked(tv)), mesh)
    layer = [ttf._kv_layer(k, 0) for k, _ in stripes], \
        [ttf._kv_layer(v, 0) for _, v in stripes]
    args = (torch.from_numpy(q), *layer, torch.from_numpy(table),
            torch.from_numpy(pos), mesh)
    got = tattn.sp_striped_paged_decode_attention(*args, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    whole = tattn.paged_decode_attention(
        torch.from_numpy(q), tk, tv, torch.from_numpy(table),
        torch.from_numpy(pos), window=window)
    np.testing.assert_allclose(got.numpy(), whole.numpy(), atol=MERGE_ATOL,
                               rtol=0)


def test_sp_merge_gives_an_empty_stripe_no_weight():
    out = torch.randn(1, 2, 1, 4)
    m = torch.tensor([[[0.5], [0.25]]])
    l = torch.tensor([[[2.0], [4.0]]])
    none = torch.full_like(m, tattn.NEG_INF)
    got = tattn.sp_merge_partials([out, torch.full_like(out, 7.0)],
                                  [m, none], [l, torch.zeros_like(l)], CPU)
    assert torch.equal(got, out)


# ---------------------------------------------------------------------------
# the mesh
# ---------------------------------------------------------------------------
def test_make_mesh_never_puts_stripes_on_a_shared_card_unasked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        tmesh.make_mesh({"sp": 2})
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tmesh.make_mesh({"ep": 1}, devices=[CPU])
    # dp is ported (sharded training): a dp axis of one is the
    # reference's mesh
    assert tmesh.make_mesh({"dp": 1}, devices=[CPU]).shape == \
        dict(jax_mesh({"dp": 1}).shape)
    # pipeline stages are ported: a pp axis of one stage is a mesh
    assert tmesh.make_mesh({"pp": 1}, devices=[CPU]).shape == {"pp": 1}
    m = tmesh.make_mesh({"sp": -1}, devices=[CPU] * 3)
    assert m.shape == {"sp": 3} and m.axis_names == ("sp",)
    assert tattn.tp_degree(m, "sp") == 3 and tattn.tp_degree(m) == 1
    assert tattn.tp_degree(None, "sp") == 1


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
def test_shard_kv_storage_splits_pages_into_stripes(kv_dtype):
    cfg = ttf.tiny(kv_dtype=kv_dtype)
    pools = ttf.init_paged_kv(cfg, 12, 4, device="cpu")
    for leaf in ttf._kv_leaves(pools[0]):
        leaf.copy_(torch.arange(leaf.numel()).reshape(leaf.shape))
    stripes = tmesh.shard_kv_storage(pools, port_mesh(3))
    assert len(stripes) == 3
    for s, (k, _) in enumerate(stripes):
        for got, full in zip(ttf._kv_leaves(k), ttf._kv_leaves(pools[0])):
            assert got.is_contiguous()
            assert torch.equal(got, full[:, 4 * s:4 * s + 4])
    # the batcher's pool, allocated per stripe, has the same layout
    fresh = ttf.init_paged_kv(cfg, 12, 4, mesh=port_mesh(3))
    assert [ttf._kv_leaf(k).shape for k, _ in fresh] == \
        [ttf._kv_leaf(k).shape for k, _ in stripes]
    with pytest.raises(ValueError, match="equal position stripes"):
        tmesh.shard_kv_storage(pools, port_mesh(5))
    with pytest.raises(ValueError, match="equal position stripes"):
        ttf.init_paged_kv(cfg, 12, 4, mesh=port_mesh(5))


# ---------------------------------------------------------------------------
# the batcher against the live JAX striped batcher
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def params():
    jparams = jtf.init_params(jax.random.PRNGKey(7), CFG)
    return jparams, params_from_numpy(
        jax.tree_util.tree_map(np.asarray, jparams), device="cpu")


@functools.lru_cache(maxsize=None)
def _jax_run(sp, kv_dtype, max_seq=96, n_pages=None, prompts=None, gen=8):
    """The JAX "xla" striped batcher's page tables after admission and
    its greedy streams."""
    cfg = dataclasses.replace(jtf.tiny(max_seq=max_seq), kv_dtype=kv_dtype)
    jparams = jtf.init_params(jax.random.PRNGKey(7), cfg)
    b = JaxPaged(jparams, cfg, n_slots=4, page_size=16, n_pages=n_pages,
                 mesh=jax_mesh({"sp": sp}))
    rids = [b.admit(list(p), gen) for p in (prompts or PROMPTS)]
    table = b.page_table.copy()
    b.run_until_drained()
    return table, [[int(t) for t in b.completed[r]] for r in rids]


def _port_batcher(tparams, sp, attn_kernel="kernel", kv_dtype="bf16",
                  max_seq=96, n_slots=4, **kw):
    cfg = ttf.tiny(max_seq=max_seq, attn_kernel=attn_kernel,
                   kv_dtype=kv_dtype)
    return PagedContinuousBatcher(tparams, cfg, n_slots=n_slots,
                                  page_size=16,
                                  mesh=port_mesh(sp) if sp > 1 else None,
                                  device=None if sp > 1 else "cpu", **kw)


def _drain(b, prompts=PROMPTS, gen=8):
    rids = [b.admit(list(p), gen) for p in prompts]
    assert all(r is not None for r in rids)
    table = b.page_table.copy()
    b.run_until_drained()
    return table, [b.completed[r] for r in rids]


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("attn_kernel", ["gather", "kernel"])
@pytest.mark.parametrize("sp", [2, 4])
def test_striped_streams_and_tables_equal_the_jax_batcher(params, sp,
                                                          attn_kernel,
                                                          kv_dtype):
    """Page tables equal the JAX batcher's after admission, and greedy
    streams are token-equal on both read arms and both pools; the pages
    go back to their stripes."""
    _, tparams = params
    want_table, want = _jax_run(sp, kv_dtype)
    b = _port_batcher(tparams, sp, attn_kernel, kv_dtype)
    table, got = _drain(b)
    np.testing.assert_array_equal(table, want_table)
    assert got == want
    per = b.n_pages // sp
    assert b.free_page_count() == b.n_pages - sp
    for s, free in enumerate(b._free_by_stripe):
        assert sorted(free) == list(range(s * per + 1, (s + 1) * per))


@pytest.mark.parametrize("kv_dtype", ["bf16", "int8"])
@pytest.mark.parametrize("sp", [2, 4])
def test_striped_gather_is_bit_identical_to_unstriped(params, sp, kv_dtype):
    """The "gather" arm striped: prefill and decode logits equal the
    unstriped run's bit for bit, and so do its streams."""
    _, tparams = params
    runs = {}
    for n in (1, sp):
        b = _port_batcher(tparams, n, "gather", kv_dtype)
        logits = []
        for slot, p in enumerate(PROMPTS):
            assert b._reserve(slot, len(p), 8)
            logits.append(b._prefill_into(slot, p))
        lengths = torch.tensor([len(p) for p in PROMPTS] + [0],
                               dtype=torch.int32)
        tok = torch.tensor([[1], [2], [3], [0]])
        dec, _ = ttf.forward_paged_decode(
            b.params, tok, b.cfg, b.pools, b._table(b.page_table), lengths,
            mesh=b.mesh)
        logits.append(dec[:3])
        for slot in range(len(PROMPTS)):
            b._release(slot)
        runs[n] = (logits, _drain(b)[1])
    for a, c in zip(runs[1][0], runs[sp][0]):
        assert torch.equal(a, c)
    assert runs[1][1] == runs[sp][1]


def test_striped_long_context_beyond_one_stripe(params):
    """A sequence whose pages fit no single stripe admits and decodes
    through the striped kernel arm, token-equal to the JAX striped
    batcher and to the port's unstriped run."""
    prompt = tuple(1 + (i % 7) for i in range(100))
    _, want = _jax_run(4, "bf16", max_seq=256, n_pages=24,
                       prompts=(prompt,))
    jparams = jtf.init_params(jax.random.PRNGKey(7), jtf.tiny(max_seq=256))
    tparams = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams),
                                device="cpu")
    b = _port_batcher(tparams, 4, max_seq=256, n_pages=24)
    # 108 tokens = 7 ranges; a single stripe holds only 5 usable pages
    assert 7 > b.n_pages // 4 - 1
    _, got = _drain(b, [prompt])
    assert got == want
    _, ref = _drain(_port_batcher(tparams, 1, max_seq=256), [prompt])
    assert got == ref


def test_striped_rounding_and_refusals_match_jax(params):
    jparams, tparams = params
    cfg256 = ttf.tiny(max_seq=256)

    def both(jcfg, tcfg, sp, **kw):
        jb = JaxPaged(jparams, jcfg, n_slots=2, page_size=16,
                      mesh=jax_mesh({"sp": sp}) if sp > 1 else None, **kw)
        tb = PagedContinuousBatcher(
            tparams, tcfg, n_slots=2, page_size=16,
            mesh=port_mesh(sp) if sp > 1 else None,
            device=None if sp > 1 else "cpu", **kw)
        return jb, tb

    # a fixed per-stripe pool of 6 pages: striped over 4, ~4x the context
    single = both(jtf.tiny(max_seq=256), cfg256, 1, n_pages=6)
    striped = both(jtf.tiny(max_seq=256), cfg256, 4, n_pages=16)
    for b in single:
        with pytest.raises(ValueError, match="usable pages"):
            b.validate_request([1] * 100, 8)
    for b in striped:
        b.validate_request([1] * 100, 8)
        with pytest.raises(ValueError, match="position stripe") as e:
            b.validate_request([1] * 248, 8)
        assert "needs 4 pages" in str(e.value)
    for make in (lambda: JaxPaged(jparams, jtf.tiny(max_seq=96, window=16),
                                  n_slots=2, page_size=16,
                                  mesh=jax_mesh({"sp": 2})),
                 lambda: PagedContinuousBatcher(
                     tparams, ttf.tiny(max_seq=96, window=16), n_slots=2,
                     page_size=16, mesh=port_mesh(2))):
        with pytest.raises(ValueError, match="full-causal"):
            make()
    # an explicit n_pages rounds UP to equal stripes, a byte budget DOWN
    rounded = both(CFG, ttf.tiny(max_seq=96), 4, n_pages=13)
    assert [b.n_pages for b in rounded] == [16, 16]
    per_page = rounded[1].storage_info()["bytes_per_page"]
    budget = both(CFG, ttf.tiny(max_seq=96), 4, pool_bytes=per_page * 11)
    assert [b.n_pages for b in budget] == [8, 8]
    for sp in (1, 4):
        default = both(CFG, ttf.tiny(max_seq=96), sp)
        assert default[0].n_pages == default[1].n_pages
    with pytest.raises(ValueError, match="per position stripe"):
        both(CFG, ttf.tiny(max_seq=96), 4, pool_bytes=per_page * 7)


@pytest.mark.parametrize("sp,spec_k", [(1, 0), (2, 0), (1, 8), (2, 8)],
                         ids=["1", "2", "1-spec8", "2-spec8"])
def test_striped_storage_info_matches_jax(params, sp, spec_k):
    """The pool's integers equal JAX's; a pool provisioned for
    speculation reports its depth and prices the merge at the verify
    read's rows, as JAX's does."""
    jparams, tparams = params
    jb = JaxPaged(jparams, CFG, n_slots=2, page_size=16,
                  mesh=jax_mesh({"sp": sp}) if sp > 1 else None,
                  spec_k=spec_k)
    tb = _port_batcher(tparams, sp, n_slots=2, spec_k=spec_k)
    ji, ti = jb.storage_info(), tb.storage_info()
    keys = ["n_pages", "pool_bytes", "bytes_per_page", "sp_shards",
            "pool_bytes_per_shard"] + (["sp_merge_transient_bytes"]
                                       if sp > 1 else [])
    assert {k: ti[k] for k in keys} == {k: ji[k] for k in keys}
    assert ti["pool_bytes_per_shard"] * sp == ti["pool_bytes"]
    assert ("sp_merge_transient_bytes" in ti) == (sp > 1)
    assert ti["free_pages"] == tb.n_pages - sp
    assert ti["spec_k"] == spec_k


def test_batcher_runs_on_the_mesh_first_device(params):
    _, tparams = params
    b = _port_batcher(tparams, 2)
    assert b.device == CPU and b.mesh.devices == (CPU, CPU)
    with pytest.raises(ValueError, match="first device"):
        PagedContinuousBatcher(tparams, ttf.tiny(max_seq=96), n_slots=2,
                               page_size=16, device="meta",
                               mesh=port_mesh(2))


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------
def _call(srv, method, path, body=None):
    req = urllib.request.Request(
        f"http://127.0.0.1:{srv.port}{path}", method=method,
        data=None if body is None else json.dumps(body).encode(),
        headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=120) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def test_server_serves_striped_and_refuses_score():
    cfg, params = build_model("tiny", seed=3, device="cpu")
    with pytest.raises(ValueError, match="paged-pool feature"):
        LLMServer(cfg, params, port=0, n_slots=2, page_size=0, device="cpu",
                  sp=2)
    srv = LLMServer(cfg, params, port=0, n_slots=2, page_size=4,
                    device="cpu", sp=2).start()
    try:
        prompts = [[1, 2, 3, 4, 5, 6, 7], [9, 8, 7]]
        code, body = _call(srv, "POST", "/generate",
                           {"tokens": prompts, "max_new_tokens": 5})
        s_code, s_body = _call(srv, "POST", "/score",
                               {"tokens": [[1, 2, 3, 4]]})
        _, stats = _call(srv, "GET", "/stats")
    finally:
        srv.stop()
    assert code == 200
    b = PagedContinuousBatcher(params, cfg, n_slots=2, page_size=4,
                               device="cpu")
    rids = [b.admit(p, 5) for p in prompts]
    b.run_until_drained()
    assert body["tokens"] == [b.completed[r] for r in rids]
    assert s_code == 400 and "mesh" in s_body["Error"]
    kv = stats["kv_storage"]
    assert kv["sp_shards"] == 2 and kv["n_pages"] % 2 == 0
    assert "paged_attn_striped" in stats["kernel_launches"]
