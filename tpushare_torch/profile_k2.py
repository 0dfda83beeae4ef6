"""K2's own device time on the card, entry point by entry point.

    python -m tpushare_torch.profile_k2 [--against DIR] [--iters N]
        [--shapes decode,prefill,chunk,short]

Times, by ``torch.profiler`` (the kernels' own durations, the 50 MB L2
flushed before every call), the four K2 entry points (bf16 pool, int8
store, and each striped on stripe 0 of 2) at ``chip_smoke.py``'s two
shapes on the full Llama-3-8B layer pool (32 heads over 8 kv heads,
D = 128, pages of 16, 512 table entries a row): ``decode`` (8 rows of
contexts 100-2000, S = 1, through the decode arm ``csrc/paged_decode.cu``)
and ``prefill`` (one 2000-token window, through ``csrc/paged_attn.cu``);
``--shapes chunk`` adds S = 64 at the decode contexts (the windowed
ring's chunk, also the prefill arm).  Each is first held to the plain
version (out, and the striped m and l).  Prints one JSON line a (entry
point, shape): the device time, the kernels launched and their launches
a call, the split plan the timed decode launches were given, the least
time the card could take and the rate in GB/s.  At ``prefill`` it also
times K1 on the same q and the same 2000 keys laid out contiguously (a
yardstick of what the paged read should approach).

With ``--against DIR`` (the root of another checkout, e.g. a ``git
archive`` of a parent commit unpacked into a git-ignored directory) it
also builds that checkout's K2 from its own sources (its ``paged_attn``,
and at S = 1 its ``paged_decode`` where it has one), holds it to the
plain version on the same inputs, and times the two in turns (theirs,
ours, ours, theirs).  ``--shapes short`` adds 8 one-page rows (nearly
every block of the grid empty).  Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json

import torch

from .ops import attention as attn
from .utils.cuda_timing import bound_ms, device_ms, l2_flush_buffer

#: chip_smoke.py's decode rows: contexts spread over the serving range
DECODE_CONTEXTS = (100, 371, 642, 913, 1184, 1455, 1726, 2000)
#: a diagnostic decode shape: 8 rows of one page each, so all but one
#: split of every row is empty (what the grid's empty blocks cost)
SHORT_CONTEXTS = (16,) * 8
#: the serving pool's page size
PAGE = 16
#: the decode arm's edges (splits of 256 keys at pages of 16, tables of
#: 160 entries): (contexts, window, n_rep, D): a 1-token context;
#: contexts one short of, at and one past a split boundary; a window of
#: 256 whose leading splits are empty; a table wider than every context;
#: n_rep 1, 4 and 8; D 64 and 128; B = 1.  ``chip_smoke.py`` and the
#: ``cuda`` tests run each through the four entry points, the striped
#: ones on each of 2 stripes (the 1- and 9-token rows keep no key of
#: stripe 1).
DECODE_EDGES = (([1, 9, 255, 256, 257], None, 4, 128),
                ([511, 512, 513, 767, 768], None, 4, 128),
                ([2000, 1000, 300], 256, 4, 128),
                ([1, 700, 2500], None, 1, 128),
                ([9, 256, 1025], 256, 8, 128),
                ([1, 255, 513, 2000], None, 4, 64),
                ([769], None, 8, 64),
                ([2560], 256, 4, 128))
#: the prefill arm's edges (S > 1, ``csrc/paged_attn.cu``): (contexts,
#: S, window, n_rep, D, page, n_tbl), q at each row's last S positions,
#: each table 8 entries wider than its longest row but the last: the
#: windowed ring's 64-token chunk at a context of ~2000, alone and in a
#: window of 256; S not a multiple of 128 at n_rep 1 (tiles that cross a
#: q head) and at n_rep 8; a window that skips whole key tiles; pages of
#: 8 and 4; a page of 6 (the bf16 pool takes any page, the int8 store a
#: multiple of 4: its entry points skip it); a table of 20,000 entries
#: (the kernel reads each key's entry from global memory, so shared
#: memory does not bound the width).  ``chip_smoke.py`` and the ``cuda``
#: tests run each through every entry point that takes its page, the
#: striped ones on each of 2 stripes.
PREFILL_EDGES = (([2000, 1990], 64, None, 4, 128, 16, 133),
                 ([1990, 700], 64, 256, 4, 128, 16, 133),
                 ([300, 1000], 200, None, 1, 128, 16, 71),
                 ([777], 777, None, 8, 64, 16, 57),
                 ([1000, 900], 1000, 300, 4, 128, 16, 71),
                 ([513, 129], 129, 100, 4, 128, 8, 73),
                 ([260], 130, None, 4, 64, 4, 73),
                 ([150], 100, None, 4, 128, 6, 33),
                 ([1000, 700], 64, None, 4, 128, 4, 20000))
ENTRY_POINTS = ("bf16", "int8", "bf16_striped", "int8_striped")


def _table(rows, n_tbl):
    table = torch.zeros(len(rows), n_tbl, dtype=torch.int32)
    for i, r in enumerate(rows):
        table[i, :len(r)] = torch.tensor(r, dtype=torch.int32)
    return table.cuda()


def paged_operands(contexts, s, seed, int8=False, n_pages=4097, hkv=8,
                   h=32, d=128, page=16, n_tbl=512):
    """(q, k_store, v_store, table, positions): q at the last ``s``
    positions of each row's context, over pages of a full-size layer pool
    drawn without replacement; with ``int8`` the pool is quantized into
    int8 {"q","s"} stores."""
    from .ops.quant import quantize_kv

    g = torch.Generator(device="cuda").manual_seed(seed)
    pool = lambda: torch.randn(n_pages, hkv, page, d, generator=g,  # noqa
                               device="cuda", dtype=torch.bfloat16)
    k_pool, v_pool = pool(), pool()
    if int8:
        k_pool, v_pool = quantize_kv(k_pool), quantize_kv(v_pool)
    q = torch.randn(len(contexts), h, s, d, generator=g, device="cuda",
                    dtype=torch.bfloat16)
    perm = (torch.randperm(n_pages - 1, generator=g, device="cuda")
            + 1).tolist()
    rows, used = [], 0
    for c in contexts:
        n = -(-c // page)
        rows.append(perm[used:used + n])
        used += n
    return (q, k_pool, v_pool, _table(rows, n_tbl),
            _positions(contexts, s))


def _positions(contexts, s):
    return torch.stack([
        torch.arange(c - s, c, dtype=torch.int32, device="cuda")
        for c in contexts]).contiguous()


def striped_operands(contexts, s, seed, int8=False, sp=2, n_pages=4098,
                     hkv=8, h=32, d=128, page=16, n_tbl=512):
    """A full-size layer pool laid out as the striped batcher lays it
    (range j of a row on stripe j % sp, never a stripe's trash page):
    (q, k_pool, v_pool, table, positions, stripes, per, mesh) with
    ``stripes`` one (k, v) store a stripe (``shard_kv_storage``) and
    ``per`` the pages a stripe."""
    from .ops.quant import quantize_kv
    from .parallel.mesh import make_mesh, shard_kv_storage

    g = torch.Generator(device="cuda").manual_seed(seed)
    per = n_pages // sp
    pool = lambda: torch.randn(n_pages, hkv, page, d, generator=g,  # noqa
                               device="cuda", dtype=torch.bfloat16)
    k_pool, v_pool = pool(), pool()
    if int8:
        k_pool, v_pool = quantize_kv(k_pool), quantize_kv(v_pool)
    q = torch.randn(len(contexts), h, s, d, generator=g, device="cuda",
                    dtype=torch.bfloat16)
    free = [(torch.randperm(per - 1, generator=g, device="cuda") + 1
             + t * per).tolist() for t in range(sp)]
    rows = [[free[j % sp].pop() for j in range(-(-c // page))]
            for c in contexts]
    table = _table(rows, n_tbl)
    mesh = make_mesh({"sp": sp}, devices=["cuda"] * sp)

    def stacked(x):
        return ({k: v[None] for k, v in x.items()} if isinstance(x, dict)
                else x[None])

    layer = [tuple({k: v[0] for k, v in x.items()} if isinstance(x, dict)
                   else x[0] for x in pair)
             for pair in shard_kv_storage((stacked(k_pool), stacked(v_pool)),
                                          mesh)]
    return (q, k_pool, v_pool, table, _positions(contexts, s), layer, per,
            mesh)


def read_cost(contexts, s, int8, n_tbl=512, hkv=8, h=32, d=128, page=16,
              sp=1, stripe=0):
    """(FLOPs, bytes) of one K2 call: the keys the rows keep, each K and
    V row read once (an int8 row: one byte a value plus its f32 scale),
    q read and out written once, the table (its stripe's local one) and
    positions, and striped the pos_map read and m, l written; operations
    QK and PV over the (query, key) pairs kept, 2 FLOP a MAC."""
    keys = pairs = 0
    for c in contexts:
        kpos = torch.cat([torch.arange(j * page, min((j + 1) * page, c))
                          for j in range(stripe, -(-c // page), sp)])
        qpos = torch.arange(c - s, c)
        keys += kpos.numel()
        pairs += int((kpos[None, :] <= qpos[:, None]).sum())
    b, n_local = len(contexts), -(-n_tbl // sp)
    kv_row = d + 4 if int8 else 2 * d
    nbytes = (2 * keys * hkv * kv_row + 2 * 2 * b * h * s * d
              + 4 * b * (n_local + s))
    if sp > 1:
        nbytes += 4 * n_local + 2 * 4 * b * h * s
    return 4.0 * d * h * pairs, nbytes


#: shape -> (contexts, S): ``decode`` and ``short`` go to the decode arm,
#: ``prefill`` (one 2000-token window) and ``chunk`` (the windowed ring's
#: 64-token chunk at the decode contexts) to the prefill arm
SHAPES = {"decode": (DECODE_CONTEXTS, 1),
          "short": (SHORT_CONTEXTS, 1),
          "prefill": ((2000,), 2000),
          "chunk": (DECODE_CONTEXTS, 64)}


def entry_case(entry: str, shape: str, seed: int = 0):
    """The operands of one entry point at one of chip_smoke.py's shapes:
    (args, kwargs, cost) for ``paged_decode_attention(*args,
    **kwargs)``, cost = (FLOPs, bytes); striped entry points read stripe
    0 of 2 with its local table and pos_map."""
    int8 = entry.startswith("int8")
    contexts, s = SHAPES[shape]
    if not entry.endswith("striped"):
        args = paged_operands(contexts, s, seed, int8=int8)
        return args, {}, read_cost(contexts, s, int8)
    q, _, _, table, pos, stripes, per, _ = striped_operands(
        contexts, s, seed, int8=int8)
    tbl, pmap = attn.striped_local_view(table, 2, 0, per, PAGE)
    return ((q, *stripes[0], tbl, pos), {"pos_map": pmap,
                                         "return_stats": True},
            read_cost(contexts, s, int8, sp=2))


def load_k2_from(root: str):
    """A launcher of K2 as the checkout at ``root`` builds it from its own
    sources into its own build directory: its ``paged_attn`` library, and
    at S = 1 its ``paged_decode`` library where it has one (split as this
    checkout splits, with tickets of its own).  ``fn(q, k_store,
    v_store, table, positions, pos_map=None, return_stats=False)`` as
    :func:`paged_decode_attention` calls it, no window."""
    from .profile_k1 import _load_cuda_from

    mod = _load_cuda_from(root, "paged_attn")
    tickets = None
    if "paged_decode" in mod.ENTRY_POINTS:
        mod.library("paged_decode")
        buf = torch.zeros(1024, dtype=torch.int32, device="cuda")
        tickets = lambda device, n: buf.data_ptr()  # noqa: E731

    def run(q, k_store, v_store, table, positions, pos_map=None,
            return_stats=False):
        leaves = ([k_store["q"], k_store["s"], v_store["q"], v_store["s"]]
                  if isinstance(k_store, dict) else [k_store, v_store])
        out, m, l, _ = attn.launch_k2(mod, q, leaves, table, positions,
                                      pos_map, 0, tickets)
        return (out, m, l) if pos_map is not None else out

    return run


def _errors(got, want) -> dict:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    out = {"max_abs_err": (got[0].float() - want[0].float()).abs().max()
           .item()}
    if len(got) == 3:
        out["m_max_abs_err"] = (got[1] - want[1]).abs().max().item()
        out["l_max_rel_err"] = ((got[2] - want[2]).abs()
                                / want[2].clamp_min(1e-30)).max().item()
    return out


def profile_case(entry: str, shape: str, iters: int, flush,
                 against=None, seed: int = 0) -> dict:
    """One entry point at one shape: held to the plain version, then its
    device time (split and combine included), kernels, bound and rate;
    with ``against``, that launcher held to the plain version too and the
    two timed in turns."""
    args, kw, (flops, nbytes) = entry_case(entry, shape, seed)
    ours = lambda: attn.paged_decode_attention(*args, **kw)  # noqa: E731
    want = attn._paged_plain(*args, None, **kw)
    res = {"entry": entry, "shape": shape, **_errors(ours(), want)}
    attn.paged_decode_attention.decode_plan = None
    ms, kernels = device_ms(ours, iters, flush)
    bound, by = bound_ms(flops, nbytes)
    res.update({"device_ms": ms, "kernels": kernels, "bound_ms": bound,
                "bound_by": by, "x_bound": ms / bound,
                "gbps": nbytes / ms / 1e6, "bytes": nbytes, "flops": flops})
    if SHAPES[shape][1] == 1:
        res["split_pages"], res["n_splits"] = \
            attn.paged_decode_attention.decode_plan
    if against is not None:
        theirs = lambda: against(*args, **kw)  # noqa: E731
        res["against"] = _errors(theirs(), want)
        del want
        order = [("against", theirs), ("this", ours), ("this", ours),
                 ("against", theirs)]
        res["turns"] = [{"which": name,
                         "device_ms": device_ms(fn, iters, flush)[0]}
                        for name, fn in order]
        res["against_kernels"] = device_ms(theirs, 2, flush)[1]
    return res


def k1_yardstick(iters: int, flush, seed: int = 0) -> dict:
    """K1 (``flash_attention_lse``, causal) on the prefill shape's q and
    its 2000 keys laid out contiguously ([1, 8, 2000, 128]), the same
    (query, key) pairs: what the paged read should approach, not a
    library row.  Its device time by the profiler, against the same
    bound as K2's bf16 prefill row."""
    args = paged_operands((2000,), 2000, seed)
    q, k_pool, v_pool, table = args[:4]
    k, v = (attn.paged_gather(x, table[:, :-(-2000 // PAGE)]).contiguous()
            for x in (k_pool, v_pool))
    fn = lambda: attn.flash_attention_lse(q, k, v)  # noqa: E731
    ms, kernels = device_ms(fn, iters, flush)
    flops, nbytes = read_cost((2000,), 2000, False)
    bound, by = bound_ms(flops, nbytes)
    return {"phase": "k1_yardstick", "device_ms": ms, "kernels": kernels,
            "bound_ms": bound, "bound_by": by, "x_bound": ms / bound}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m tpushare_torch.profile_k2")
    ap.add_argument("--against", default=None,
                    help="root of another checkout whose paged_attn "
                         "library is timed in turns with this one")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--shapes", default="decode,prefill",
                    help="of decode, prefill, chunk (S = 64 at the decode "
                         "contexts) and short (8 one-page rows)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_k2 needs a CUDA device")
    against = load_k2_from(args.against) if args.against else None
    flush = l2_flush_buffer()
    dev = torch.cuda.get_device_name(0)
    for shape in args.shapes.split(","):
        for entry in ENTRY_POINTS:
            res = profile_case(entry, shape, args.iters, flush, against)
            res.update({"phase": "k2", "device": dev})
            print(json.dumps(res), flush=True)
            torch.cuda.empty_cache()
        if shape == "prefill":
            res = k1_yardstick(args.iters, flush)
            res["device"] = dev
            print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
