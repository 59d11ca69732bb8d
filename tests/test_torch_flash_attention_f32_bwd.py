"""The float32 flash-attention backward kernels' arithmetic, on the CPU.

``csrc/flash_attention_bwd.cu`` runs float32 through the two kernels of its
``tf32x3`` namespace, dq then dkdv, whose products are 3xTF32
``mma.sync.m16n8k8``.  They run only on the card, where ``chip_smoke.py``
holds them to ``flash_attention_bwd_ref`` within FLASH_BWD_F32_TOL (1e-4 of
each output's max |plain|).  Here, with the tiles, ring and rules read from
the source:

* the fragment layouts lane by lane on one tile (``lane_two_scores``,
  ``lane_accumulate``): the float4 reads of the score products' permuted
  k8 steps, the accumulator registers taken as the A fragment as they stand
  (the contraction permuted: logical k = q is row 2q, k = q + 4 row 2q + 1)
  and the permuted output columns, against plain products;
* the swizzle (``swz``): every fragment read and tile copy of a quarter-warp
  hits 32 distinct banks;
* the skip rules: each block visits exactly the live tiles, and each warp's
  ``live`` and ``edge`` agree with the mask;
* the shared memory of the four instantiations;
* ``tf32x3_bwd_emulation``, the kernels' numerics in torch ops (each
  operand's TF32 high part rounded as ``tf32::split_rn`` rounds it, the
  remainder read by the mma cut to TF32, ``& 0xffffe000``; three products a
  k8 step with lo x lo dropped, cut toward zero, each block's sum added to
  float32 sums rounded to nearest; the large P's S and dP summed again one
  FMA a d in order; the visit order and the rules above), within 1e-4 of
  each output's max |x| of ``flash_attention_bwd_ref`` and of JAX's vjp of
  ``_mha_streaming``, and at the random-weight models' scale within twice
  the plain float32 backward's distance from a float64 backward.
"""

import functools
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels.flash_attention.ops import expand_kv
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_bwd_ref,
    mha_streaming,
)

from test_torch_flash_attention import (
    BWD_SOURCE,
    SMEM_PER_BLOCK,
    _c_to_py,
    _cu_text,
    _fma_rows,
    built_pairs,
    jax_attention_vjp,
    pair_tiles,
    rel_max,
)

torch.set_num_threads(1)

F32_TOL = 1e-4            # chip_smoke.py FLASH_BWD_F32_TOL


@functools.cache
def _f32_namespace():
    """The float32 kernels' part of the backward source."""
    text = _cu_text(BWD_SOURCE)
    return text[text.index("namespace tf32x3 {"):
                text.index("namespace tensor_core {")]


@functools.cache
def _f32_constants(d, dv):
    text = _f32_namespace()
    c = {m[1]: int(m[2]) for m in re.finditer(
        r"^constexpr int (k\w+) = (\d+);", text, re.M)}
    return {**c, **pair_tiles(text, d, dv)}


def f32_constants(pair=(128, 128)):
    """The float32 backward's constants at the (d, dv) ``pair``: the
    namespace's ``constexpr int k...`` and the pair's ``Tiles``."""
    return dict(_f32_constants(*pair))


@functools.cache
def _expr(kind, name, which=0):
    """The ``which``-th ``const <kind> <name> = ...;`` of the float32
    kernels, compiled as Python."""
    found = re.findall(rf"const {kind} {name} =\s*(.+?);", _f32_namespace(),
                       re.S)
    py = _c_to_py(found[which]).replace("||", " or ")
    return compile(py, name, "eval")


def f32_rule(name, which=0, pair=(128, 128), **env):
    return eval(_expr("int", name, which), {"min": min, "max": max},
                {**f32_constants(pair), **env})


def dq_key_tiles(q0, s, t, window, pair=(128, 128)):
    """The dq block at query row q0 visits these key tiles (k0 values)."""
    env = dict(q0=q0, S=s, Tk=t, window=window or 0)
    for name in ("k_stop", "k_min", "k_first", "n_tiles"):
        env[name] = f32_rule(name, pair=pair, **env)
    return [env["k_first"] + i * f32_constants(pair)["kDqKeys"]
            for i in range(env["n_tiles"])]


def dkdv_query_tiles(k0, s, t, window, pair=(128, 128)):
    """The dkdv block at key k0 visits these query tiles (q0 values), for
    each query head of its group."""
    env = dict(k0=k0, S=s, Tk=t, window=window or 0)
    for name in ("q_begin", "q_end", "n_q"):
        env[name] = f32_rule(name, pair=pair, **env)
    return [env["q_begin"] + i * f32_constants(pair)["kKvRows"]
            for i in range(env["n_q"])]


def warp_rules(which, s, t, window, pair=(128, 128)):
    """``live`` and ``edge`` of every warp part of every tile: for dq
    (which 0), indexed [row // 16, key // kDqKeys]; for dkdv (which 1),
    [key // 16, query // kKvRows]."""
    c = f32_constants(pair)
    live_e, edge_e = _expr("bool", "live", which), _expr("bool", "edge",
                                                         which)
    n_warp = -(-(s if which == 0 else t) // 16)
    tile = c["kDqKeys"] if which == 0 else c["kKvRows"]
    n_tile = -(-(t if which == 0 else s) // tile)
    live = torch.zeros((n_warp, n_tile), dtype=torch.bool)
    edge = torch.zeros_like(live)
    for w in range(n_warp):
        for i in range(n_tile):
            env = dict(c, S=s, Tk=t, window=window or 0)
            if which == 0:
                env.update(r_lo=16 * w, k0=i * tile)
                env.update(k1=f32_rule("k1", **env), rl=f32_rule("rl", **env))
            else:
                env.update(kw=16 * w, q0=i * tile)
                env.update(q1=f32_rule("q1", **env), kl=f32_rule("kl", **env))
            live[w, i] = eval(live_e, {}, env)
            edge[w, i] = eval(edge_e, {}, env)
    return live, edge


def visible(s, t, window):
    rows, cols = torch.arange(s)[:, None], torch.arange(t)[None]
    mask = cols <= rows
    if window:
        mask &= cols > rows - window
    return mask


def kept(s, t, window, pair=(128, 128)):
    """(s, t) masks of the (query, key) pairs whose P each kernel keeps, by
    its visit order, warp and mask rules at ``pair``'s tiles: dq's, then
    dkdv's.  Pairs outside a visited tile, in a warp's part that skips the
    tile, or masked in an edge part are 0; a part without an edge keeps
    every pair."""
    c = f32_constants(pair)
    mask = visible(s, t, window)
    rows, cols = torch.arange(s)[:, None], torch.arange(t)[None]
    n_kt, n_qt = -(-t // c["kDqKeys"]), -(-s // c["kKvRows"])
    dq_tiles = [dq_key_tiles(q0, s, t, window, pair)
                for q0 in range(0, s, c["kDqRows"])]
    visit = torch.tensor([[i * c["kDqKeys"] in tiles for i in range(n_kt)]
                          for tiles in dq_tiles])
    tile = cols // c["kDqKeys"]
    live, edge = warp_rules(0, s, t, window, pair)
    dq = (visit[rows // c["kDqRows"], tile] & live[rows // 16, tile]
          & (mask | ~edge[rows // 16, tile]))
    kv_tiles = [dkdv_query_tiles(k0, s, t, window, pair)
                for k0 in range(0, t, c["kKvKeys"])]
    visit = torch.tensor([[i * c["kKvRows"] in tiles for i in range(n_qt)]
                          for tiles in kv_tiles])
    tile = rows // c["kKvRows"]
    live, edge = warp_rules(1, s, t, window, pair)
    kv = (visit[cols // c["kKvKeys"], tile] & live[cols // 16, tile]
          & (mask | ~edge[cols // 16, tile]))
    return dq, kv


# -- the fragment layouts, lane by lane ---------------------------------------
#
# mma.sync.m16n8k8 (PTX ISA, "Matrix fragments for mma.m16n8k8", .tf32):
# lane 4g + q holds A (g, q), (g + 8, q), (g, q + 4), (g + 8, q + 4); B (q, g),
# (q + 4, g); C (g, 2q), (g, 2q + 1), (g + 8, 2q), (g + 8, 2q + 1).

@functools.cache
def _swz_code():
    return compile(re.search(r"int swz\(int r\) \{ return (.+?); \}",
                             _f32_namespace())[1], "swz", "eval")


def swz(r):
    """The source's ``swz``."""
    return eval(_swz_code(), {}, {"r": r})


def at(r, c, D):
    """The source's ``at<D>``: (row r, columns c..c + 3) in a tile."""
    return r * D + (((c >> 2) ^ swz(r)) << 2)


def mma(c, a, b):
    """One mma.sync.m16n8k8 on per-lane registers (float64, exact):
    c[lane][4] += A B, a[lane][4], b[lane][2]."""
    A, B = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        g, q = divmod(lane, 4)
        A[g, q], A[g + 8, q], A[g, q + 4], A[g + 8, q + 4] = a[lane]
        B[q, g], B[q + 4, g] = b[lane]
    C = A @ B
    for lane in range(32):
        g, q = divmod(lane, 4)
        c[lane] += [C[g, 2 * q], C[g, 2 * q + 1], C[g + 8, 2 * q],
                    C[g + 8, 2 * q + 1]]


def lane_two_scores(X, Y, x0, D, N):
    """two_scores' s for one warp: X, Y swizzled tiles (flat) -> s[lane][j]
    [e], from each lane's float4 reads as the kernel makes them."""
    s = np.zeros((32, N // 8, 4))
    for kk in range(D // 16):
        for h in range(2):
            a = np.zeros((32, 4))
            for lane in range(32):
                g, q = divmod(lane, 4)
                col = 16 * kk + 4 * q
                x = X[at(x0 + g, col, D):][:4]
                x8 = X[at(x0 + g + 8, col, D):][:4]
                a[lane] = [x[2 * h], x8[2 * h], x[2 * h + 1], x8[2 * h + 1]]
            for j in range(N // 8):
                b = np.zeros((32, 2))
                for lane in range(32):
                    g, q = divmod(lane, 4)
                    y = Y[at(8 * j + g, 16 * kk + 4 * q, D):][:4]
                    b[lane] = [y[2 * h], y[2 * h + 1]]
                mma(s[:, j], a, b)
    return s


def lane_accumulate(sc, Z, D, N, b_row=lambda j, q, e: 8 * j + 2 * q + e):
    """accumulate's acc for one warp: A = sc[lane][j][e] as it stands, Z a
    swizzled tile (flat) -> acc[lane][cg][t][e]; lane (g, q) reads B's
    values for logical k = q + 4e from row ``b_row(j, q, e)`` of Z."""
    acc = np.zeros((32, D // 32, 4, 4))
    for j in range(N // 8):
        a = sc[:, j][:, [0, 2, 1, 3]]
        for cg in range(D // 32):
            z = [[Z[at(b_row(j, q, e), 32 * cg + 4 * g, D):][:4]
                  for e in range(2)] for g, q in map(lambda x: divmod(x, 4),
                                                      range(32))]
            for t in range(4):
                b = np.array([[z[lane][0][t], z[lane][1][t]]
                              for lane in range(32)])
                mma(acc[:, cg, t], a, b)
    return acc


def swizzled(tile):
    """A (rows, D) array as the kernel's swizzled tile, flat."""
    rows, D = tile.shape
    flat = np.zeros(rows * D)
    for r in range(rows):
        for c in range(0, D, 4):
            flat[at(r, c, D):at(r, c, D) + 4] = tile[r, c:c + 4]
    return flat


@pytest.mark.parametrize("D", [64, 128])
def test_fragment_layouts_give_the_products(D):
    """The score product of the warp's 16 rows and the accumulating product
    from its registers, lane by lane, equal the plain products: each
    accumulator element (lane, j, e) is S(g + 8 (e >> 1), 8j + 2q + (e & 1)),
    and accumulate's (lane, cg, t, e) is (A Z)(g + 8 (e >> 1), 32 cg + 8q +
    4 (e & 1) + t), the columns ``store_rows`` writes."""
    rng = np.random.default_rng(D)
    N, x0 = 16, 16
    X, Y, Z = (rng.standard_normal(shape) for shape in ((48, D), (N, D),
                                                        (N, D)))
    s = lane_two_scores(swizzled(X), swizzled(Y), x0, D, N)
    want = X[x0:x0 + 16] @ Y.T
    got = np.zeros((16, N))
    for lane in range(32):
        g, q = divmod(lane, 4)
        for j in range(N // 8):
            for e in range(4):
                got[g + 8 * (e >> 1), 8 * j + 2 * q + (e & 1)] = s[lane, j, e]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    acc = lane_accumulate(s, swizzled(Z), D, N)
    want = got @ Z
    out = np.full((16, D), np.nan)
    for lane in range(32):
        g, q = divmod(lane, 4)
        for cg in range(D // 32):
            for t in range(4):
                for e in range(4):
                    out[g + 8 * (e >> 1),
                        32 * cg + 8 * q + 4 * (e & 1) + t] = acc[lane, cg, t, e]
    np.testing.assert_allclose(out, want, rtol=1e-12, atol=1e-12)


def test_registers_as_a_fragment_need_the_permuted_rows():
    """Control: the accumulator registers taken as the A fragment with B's
    rows in their natural order (q and q + 4) give a wrong product."""
    rng = np.random.default_rng(1)
    D, N = 64, 16
    X, Y, Z = (rng.standard_normal(shape) for shape in ((16, D), (N, D),
                                                        (N, D)))
    s = lane_two_scores(swizzled(X), swizzled(Y), 0, D, N)
    want = lane_accumulate(s, swizzled(Z), D, N)
    wrong = lane_accumulate(s, swizzled(Z), D, N,
                            b_row=lambda j, q, e: 8 * j + q + 4 * e)
    assert np.abs(wrong - want).max() > 0.1 * np.abs(want).max()


@pytest.mark.parametrize("D", [64, 128])
def test_swizzle_gives_each_quarter_warp_32_banks(D):
    """Every float4 read of the products and every 16-byte copy into a
    tile: within each quarter-warp (the unit of a 16-byte access) the 8
    lanes' 32 words fall in 32 distinct banks."""
    def distinct(words):                  # words[lane] = first word index
        for p in range(4):
            banks = {(w + i) % 32 for w in words[8 * p:8 * p + 8]
                     for i in range(4)}
            assert len(banks) == 32, (p, sorted(banks))

    lanes = [divmod(lane, 4) for lane in range(32)]
    for x0 in range(0, 128, 16):          # two_scores' A reads, rows g, g + 8
        for kk in range(D // 16):
            for half in (0, 8):
                distinct([at(x0 + g + half, 16 * kk + 4 * q, D)
                          for g, q in lanes])
    for j in range(4):                    # its B reads, rows 8j + g
        for kk in range(D // 16):
            distinct([at(8 * j + g, 16 * kk + 4 * q, D) for g, q in lanes])
    for j in range(4):                    # accumulate's B reads
        for cg in range(D // 32):
            for e in range(2):
                distinct([at(8 * j + 2 * q + e, 32 * cg + 4 * g, D)
                          for g, q in lanes])
    C = D // 4                            # load_tile's copies, 32 threads
    for base in range(0, 8 * C, 32):
        distinct([at((base + i) // C, 4 * ((base + i) % C), D)
                  for i in range(32)])


# shared memory of the float32 kernels at each built pair: (64, 64) and
# (128, 128) as before MLA's pair was built, MLA's at 64 rows (keys) a block
F32_SMEM = {(64, 64): (114688, 116608), (128, 128): (229376, 231296),
            (192, 128): (204800, 206720)}


def test_tiles_fit_shared_memory():
    """``dq_smem`` and ``dkdv_smem`` of the source at each built (d, dv)
    pair and its tiles, within the 227 KB a block may have (MLA's at its
    own tiles: at the equal pairs' it would not fit); the rows a dkdv tile
    reads from the scratch were written by a dq block."""
    assert built_pairs("tf32x3") == sorted(F32_SMEM)
    exprs = {fn: _c_to_py(re.search(
        rf"constexpr size_t {fn}\(\) \{{\s*return (.+?);",
        _f32_namespace(), re.S)[1].replace("Tiles<DQK, DV>::", ""))
        for fn in ("dq_smem", "dkdv_smem")}
    equal = f32_constants((128, 128))
    for (d, dv), want in F32_SMEM.items():
        c = f32_constants((d, dv))
        assert c["kPad"] % c["kDqRows"] == 0
        assert c["kDqRows"] % c["kKvRows"] == 0
        need = tuple(eval(exprs[fn], {}, {**c, "DQK": d, "DV": dv})
                     for fn in ("dq_smem", "dkdv_smem"))
        assert need == want and max(need) <= SMEM_PER_BLOCK, (d, dv, need)
        over = [eval(exprs[fn], {}, {**equal, "DQK": d, "DV": dv})
                for fn in ("dq_smem", "dkdv_smem")]
        assert (min(over) > SMEM_PER_BLOCK) == (d != dv), (d, dv, over)


@pytest.mark.parametrize("s,t,window", [
    (2048, 2048, None), (650, 650, None), (777, 777, 100), (4000, 4000, 1024),
    (130, 130, 7), (300, 300, 64), (200, 333, None), (333, 200, 50),
    (1, 1, None),
])
def test_skip_rules_visit_exactly_the_live_tiles(s, t, window):
    """Each block visits exactly the tiles in which the mask leaves a pair;
    a warp's part of a visited tile is ``live`` exactly when the mask
    leaves it a pair, and not ``edge`` only when the mask leaves it every
    pair (dq: its rows below S; dkdv: its keys and queries in range)."""
    skip_rules_check(s, t, window, (128, 128))


@pytest.mark.parametrize("s,t,window", [
    (2048, 2048, None), (650, 650, None), (777, 777, 100), (130, 130, 7),
    (200, 333, None), (333, 200, 50), (1, 1, None),
])
def test_skip_rules_at_mla_tiles(s, t, window):
    """The same at MLA's (192, 128) tiles: 64 rows (keys) a block."""
    c = f32_constants((192, 128))
    assert (c["kDqRows"], c["kKvKeys"]) == (64, 64)
    skip_rules_check(s, t, window, (192, 128))


def skip_rules_check(s, t, window, pair):
    c = f32_constants(pair)
    mask = visible(s, t, window)
    for q0 in range(0, s, c["kDqRows"]):
        live = [k0 for k0 in range(0, t, c["kDqKeys"])
                if mask[q0:q0 + c["kDqRows"], k0:k0 + c["kDqKeys"]].any()]
        assert dq_key_tiles(q0, s, t, window, pair) == live, q0
    for k0 in range(0, t, c["kKvKeys"]):
        live = [q0 for q0 in range(0, s, c["kKvRows"])
                if mask[q0:q0 + c["kKvRows"], k0:k0 + c["kKvKeys"]].any()]
        assert dkdv_query_tiles(k0, s, t, window, pair) == live, k0
    for which, tile in ((0, c["kDqKeys"]), (1, c["kKvRows"])):
        live, edge = warp_rules(which, s, t, window, pair)
        part_of = mask if which == 0 else mask.T
        for w in range(live.shape[0]):
            for i in range(live.shape[1]):
                part = part_of[16 * w:16 * w + 16, i * tile:(i + 1) * tile]
                full = part.shape == (16, tile) or which == 0 and \
                    part.shape[1] == tile
                assert bool(live[w, i]) == bool(part.any()), (which, w, i)
                if not edge[w, i]:
                    assert full and bool(part.all()), (which, w, i)


# -- the numerics -------------------------------------------------------------

def tf32_cut(x):
    """x cut to TF32's 10 mantissa bits: how the mma reads a float32."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def tf32_round(x):
    """x rounded to TF32's 10 mantissa bits, ties away from zero
    (``tf32::split_rn``'s hi: add 0x1000 to the bits, then cut)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def to_f32(x, toward_zero):
    """float64 -> float32, to nearest or, as the tensor cores round a sum,
    toward zero (``wgmma_sum`` of test_torch_flash_attention.py): the 29
    mantissa bits float32 lacks cleared, then exact."""
    if toward_zero:
        x = (x.view(torch.int64) & -(1 << 29)).view(torch.float64)
    return x.float()


def block_sum(steps, eq, kind, cross_apart=False):
    """The sum of a block's k8 steps [(a, b), ...] of ``einsum(eq, a, b)``
    from zero sums, as the kernels take it before adding it to their float32
    sums.  ``kind`` "3xtf32", the kernels': three mma a step (lo(a) hi(b),
    hi(a) lo(b), hi(a) hi(b); hi rounded as ``tf32::split_rn`` rounds it, lo
    = x - hi read as the mma reads it, cut to TF32; lo lo dropped), each
    adding its 8 terms exactly to the sums and cutting them toward zero;
    "3xtf32_cut", the same with hi cut (``tf32::split``); "tf32", one mma
    of the operands rounded to TF32; "float32", the float32 operands' one
    product a step, added exactly and rounded to nearest.  With
    ``cross_apart`` (``accumulate``'s kApart) the 3xTF32 kinds keep hi hi
    and the two cross terms in sums of their own and add the two at the
    end, rounded to nearest."""
    sums = {}
    for a, b in steps:
        if kind == "float32":
            pairs = [(a, b)]
        else:
            hi = tf32_cut if kind == "3xtf32_cut" else tf32_round
            ah, bh = hi(a), hi(b)
            pairs = [(ah, bh)] if kind == "tf32" else [
                (tf32_cut(a - ah), bh), (ah, tf32_cut(b - bh)), (ah, bh)]
        for n, (x, y) in enumerate(pairs):
            key = int(cross_apart and n == 2)
            e = torch.einsum(eq, x.double(), y.double())
            sums[key] = to_f32(e if key not in sums
                               else sums[key].double() + e, kind != "float32")
    return sums[0] if len(sums) == 1 else sums[1] + sums[0]


def scores(x, y, kind):
    """x (..., m, D) as the A operand, y (..., n, D) as B -> (..., m, n): a
    score product in the kernel's order, blocks kk of 16 d, each of two k8
    steps h taking d = 16 kk + 4 i + 2 h and d + 1 (i = 0..3), each block's
    sum added to the float32 sums (to nearest)."""
    acc = torch.zeros(torch.broadcast_shapes(x.shape[:-2], y.shape[:-2])
                      + (x.shape[-2], y.shape[-2]))
    for kk in range(x.shape[-1] // 16):
        d = [[16 * kk + 4 * i + 2 * h + e for i in range(4) for e in range(2)]
             for h in range(2)]
        acc = acc + block_sum([(x[..., di], y[..., di]) for di in d],
                              "...md,...nd->...mn", kind)
    return acc


def tile_sum(a, z, n0, n, eq, kind, apart):
    """One ``accumulate`` call's sum: a[..., n0:n0 + n] z[..., n0:n0 + n, :]
    over k8 steps of 8 in order; ``apart`` its kApart (dkdv's: hi hi apart
    from the cross terms)."""
    return block_sum([(a[..., c:c + 8], z[..., c:c + 8, :])
                      for c in range(n0, n0 + n, 8)], eq, kind,
                     cross_apart=apart)


@functools.cache
def k_redo():
    """The source's ``kRedo``."""
    return float(re.search(r"constexpr float kRedo = ([\d.]+)f;",
                           _f32_namespace())[1])


def probs(s, d, keep, lse, scale, xs, ys, us, ws, redo):
    """P and dP of the kernels' elementwise step: P = exp(scale S - lse), 0
    where not kept; where P |scale S| > kRedo (with ``redo``), S and dP
    summed again one FMA a d in order (``in_order``) from the pairs' rows,
    xs . ys and us . ws, each (..., m, n, D) indexed as s (dkdv takes dq's
    sums from the row's slot where it has one: the same bits)."""
    x = s * scale
    p = torch.where(keep, torch.exp(x - lse), 0.0)
    if redo:
        at = (p * x.abs() > k_redo()).nonzero(as_tuple=True)
        rows, cols = at[:-1], at[:-2] + at[-1:]
        x, d = x.clone(), d.clone()
        x[at] = _fma_rows(xs[rows], ys[cols]) * scale
        d[at] = _fma_rows(us[rows], ws[cols])
        p = torch.where(keep, torch.exp(x - lse), 0.0)
    return p, d


def tf32x3_bwd_emulation(q, k, v, o, dout, lse, scale, window=None,
                         kind="3xtf32", redo=True):
    """q (b, s, H, d), k (b, t, KV, d), v (b, t, KV, dv), o, dout (b, s, H,
    dv), lse (b, H, s) float32 -> (dq, dk, dv) as the float32 kernels
    compute them at the (d, dv) pair's tiles (another ``kind`` of
    ``block_sum``: the same tiles and order with those products; without
    ``redo``, no large P's S and dP summed again in order)."""
    scale = torch.tensor(scale, dtype=torch.float32)     # the kernels' float
    b, s, H, d = q.shape
    t, KV, dv = k.shape[1], k.shape[2], v.shape[-1]
    c = f32_constants((d, dv))
    G = H // KV
    qf, gf, of = (x.transpose(1, 2) for x in (q, dout, o))     # (b, H, s, d)
    kf, vf = (x.transpose(1, 2) for x in (k, v))               # (b, KV, t, d)
    quarters = [_fma_rows(gf[..., i * dv // 4:(i + 1) * dv // 4],
                          of[..., i * dv // 4:(i + 1) * dv // 4])
                for i in range(4)]
    dl = (quarters[0] + quarters[1]) + (quarters[2] + quarters[3])
    keep_dq, keep_kv = kept(s, t, window, (d, dv))

    # dq: S = Q K^T, dP = dO V^T; dQ over the key tiles in order
    ke, ve = (x.repeat_interleave(G, dim=1) for x in (kf, vf))
    p, dp = probs(scores(qf, ke, kind), scores(gf, ve, kind), keep_dq,
                  lse[..., None], scale, qf, ke, gf, ve, redo)
    ds = p * (dp - dl[..., None])
    acc = torch.zeros((b, H, s, d))
    for k0 in range(0, t, c["kDqKeys"]):
        acc = acc + tile_sum(ds, ke, k0, c["kDqKeys"], "bhsk,bhkd->bhsd",
                             kind, apart=False)
    dq = acc * scale

    # dkdv: S^T = K Q^T, dP^T = V dO^T for the group's heads; dK and dV
    # over the heads in order, each over its query tiles in order
    qg, gg = qf.reshape(b, KV, G, s, d), gf.reshape(b, KV, G, s, dv)
    lg, dlg = (x.reshape(b, KV, G, 1, s) for x in (lse, dl))
    kg, vg = (x[:, :, None].expand(b, KV, G, t, x.shape[-1])
              for x in (kf, vf))
    pt, dpt = probs(scores(kf[:, :, None], qg, kind),     # (b, KV, G, t, s)
                    scores(vf[:, :, None], gg, kind), keep_kv.T, lg, scale,
                    kg, qg, vg, gg, redo)
    dst = pt * (dpt - dlg)
    ak = torch.zeros((b, KV, t, d))
    av = torch.zeros((b, KV, t, dv))
    for g in range(G):
        for q0 in range(0, s, c["kKvRows"]):
            av = av + tile_sum(pt[:, :, g], gg[:, :, g], q0, c["kKvRows"],
                               "bhkr,bhrd->bhkd", kind, apart=True)
            ak = ak + tile_sum(dst[:, :, g], qg[:, :, g], q0, c["kKvRows"],
                               "bhkr,bhrd->bhkd", kind, apart=True)
    return dq.transpose(1, 2), (ak * scale).transpose(1, 2), av.transpose(1, 2)


def f32_inputs(b, s, H, KV, d, seed, qk=1.0, vs=1.0, dv=None):
    """numpy-drawn q, k, v, dout (float32); v and dout dv wide (None: d)."""
    rng = np.random.default_rng(seed)
    dv = d if dv is None else dv
    return [(amp * rng.standard_normal(shape)).astype(np.float32)
            for shape, amp in (((b, s, H, d), qk), ((b, s, KV, d), qk),
                               ((b, s, KV, dv), vs), ((b, s, H, dv), 1.0))]


def plain_case(q, k, v, dout, scale, window=None):
    """The plain forward's (O, lse) and the plain backward on them."""
    H, s = q.shape[2], q.shape[1]
    pos = torch.arange(s)
    o, lse = mha_streaming(q, expand_kv(k, H), expand_kv(v, H), pos, pos,
                           scale, window=window, return_lse=True)
    return o, lse, flash_attention_bwd_ref(q, k, v, o, dout, lse,
                                           window=window, scale=scale)


@pytest.mark.parametrize("b,s,H,KV,d,window", [
    (1, 650, 4, 4, 64, None),         # group 1, S ragged against the tiles
    (1, 520, 4, 1, 128, None),        # group 4 (yi's), d 128
    (1, 400, 8, 1, 64, 200),          # group 8, a window
    (2, 333, 4, 1, 128, 50),          # group 4, a window, two batches
    # MLA's (d, dv), ragged against 64 rows (keys) a block; and a window
    # with GQA
    (1, 300, 4, 4, (192, 128), None),
    (2, 200, 4, 2, (192, 128), 40),
])
def test_emulation_within_the_bound_of_plain_and_jax(b, s, H, KV, d, window):
    d, dv = d if isinstance(d, tuple) else (d, d)
    arrs = f32_inputs(b, s, H, KV, d, s + H + d, dv=dv)
    q, k, v, dout = (torch.tensor(a) for a in arrs)
    scale = d ** -0.5
    o, lse, want = plain_case(q, k, v, dout, scale, window)
    got = tf32x3_bwd_emulation(q, k, v, o, dout, lse, scale, window)
    jax_got = jax_attention_vjp(*arrs[:3], arrs[3], window, scale)
    for name, a, w, j in zip(("dq", "dk", "dv"), got, want, jax_got):
        assert a.shape == w.shape and a.dtype == torch.float32, name
        assert rel_max(a.numpy(), w.numpy()) <= F32_TOL, name
        assert rel_max(a.numpy(), j) <= F32_TOL, name


def dense_bwd64(q, k, v, dout, scale):
    """The causal backward in float64, dense: (dq, dk, dv)."""
    q, k, v, dout = (x.double() for x in (q, k, v, dout))
    b, s, H, d = q.shape
    KV = k.shape[2]
    ke, ve = expand_kv(k, H), expand_kv(v, H)
    logits = torch.einsum("bshd,bthd->bhst", q, ke) * scale
    p = torch.softmax(logits.masked_fill(~visible(s, s, None), -torch.inf),
                      dim=-1)
    o = torch.einsum("bhst,bthd->bshd", p, ve)
    dl = (dout * o).sum(-1).transpose(1, 2)
    dp = torch.einsum("bshd,bthd->bhst", dout, ve)
    ds = p * (dp - dl[..., None])
    dq = torch.einsum("bhst,bthd->bshd", ds, ke) * scale
    dk = torch.einsum("bhst,bshd->bthd", ds, q) * scale
    dv = torch.einsum("bhst,bshd->bthd", p, dout)
    return dq, *(x.reshape(b, s, KV, H // KV, d).sum(3) for x in (dk, dv))


def test_emulation_at_yi_scale(capsys):
    """q and k at 30x unit scale, v at 9x (the random-weight models' scale:
    logits of ~1e3, whose error P takes as it is), 1 x 384 x 8/2 x 128, each
    against a float64 backward, the products alone (no sums again in order):
    there float32 itself misses 1e-4 (the plain backward, and the float32
    emulation, the same tiles and order with float32 operands and one
    product a k8 step, read 3e-4 to 7e-4 of max |x|), and a few entries
    decide each reading.  The design's products stay within twice the plain
    float32 backward's own distance on each output; the high parts cut
    instead of rounded (``tf32::split``) read about twice the float32
    emulation.  All are printed."""
    q, k, v, dout = (torch.tensor(a) for a in
                     f32_inputs(1, 384, 8, 2, 128, 3, qk=30.0, vs=9.0))
    scale = 128 ** -0.5
    o, lse, plain = plain_case(q, k, v, dout, scale)
    exact = dense_bwd64(q, k, v, dout, scale)
    errs = {kind: [rel_max(a.numpy(), w.numpy()) for a, w in zip(
        tf32x3_bwd_emulation(q, k, v, o, dout, lse, scale, kind=kind,
                             redo=False), exact)]
        for kind in ("3xtf32", "3xtf32_cut", "float32")}
    errs["plain"] = [rel_max(a.numpy(), w.numpy())
                     for a, w in zip(plain, exact)]
    with capsys.disabled():
        print("\nfloat32 flash backward at yi's scale, dq/dk/dv of max |x| "
              "from a float64 backward: " + ", ".join(
                  f"{kind} " + "/".join(f"{x:.3g}" for x in e)
                  for kind, e in errs.items()))
    assert all(a <= 2 * b for a, b in zip(errs["3xtf32"], errs["plain"]))


def in_order_bwd(q, k, v, o, dout, lse, scale):
    """The causal backward as ``flash_attention_bwd_ref`` computes it on the
    card, whose products (cuBLAS in float32) sum one FMA a d in order: S
    and dP so, P = exp(scale S - lse) and dS = P (dP - Dl) in float32, the
    accumulating products in float64."""
    b, s, H, d = q.shape
    KV = k.shape[2]
    qf, gf, of = (x.transpose(1, 2) for x in (q, dout, o))     # (b, H, s, d)
    ke, ve = (expand_kv(x, H).transpose(1, 2) for x in (k, v))
    sc = _fma_rows(qf[..., :, None, :], ke[..., None, :, :])
    dp = _fma_rows(gf[..., :, None, :], ve[..., None, :, :])
    p = torch.where(visible(s, s, None),
                    torch.exp(sc * torch.tensor(scale) - lse[..., None]), 0.0)
    dl = (gf.double() * of.double()).sum(-1).float()
    ds = (p * (dp - dl[..., None])).double()
    dq = torch.einsum("bhst,bhtd->bshd", ds, ke.double()) * scale
    dk = torch.einsum("bhst,bhsd->bthd", ds, qf.double()) * scale
    dv = torch.einsum("bhst,bhsd->bthd", p.double(), gf.double())
    return dq, *(x.reshape(b, s, KV, H // KV, d).sum(3) for x in (dk, dv))


def test_large_logits_take_the_forwards_sums(capsys):
    """At the random-weight models' scale (q, k at 30x, v at 9x: logits of
    ~1e3), P = exp(scale S - lse) moves by |scale S| 2^-24 for each ulp of
    S, so the backward holds to the forward's lse only with S summed as the
    forward and the plain backward sum it (on the card, one FMA a d in
    order; dS = P (dP - Dl) cancels there, so dP too).  With S and dP
    summed again so where P |scale S| > kRedo, the design is within 1e-4 of
    each output's max of ``in_order_bwd``, the plain backward's sums;
    without, the 3xTF32 sums alone are not."""
    q, k, v, dout = (torch.tensor(a) for a in
                     f32_inputs(1, 384, 8, 2, 128, 4, qk=30.0, vs=9.0))
    scale = 128 ** -0.5
    o, lse, _ = plain_case(q, k, v, dout, scale)
    want = in_order_bwd(q, k, v, o, dout, lse, scale)
    errs = {redo: [rel_max(a.numpy(), w.numpy()) for a, w in zip(
        tf32x3_bwd_emulation(q, k, v, o, dout, lse, scale, redo=redo), want)]
        for redo in (True, False)}
    with capsys.disabled():
        print("\nfloat32 flash backward at yi's scale, dq/dk/dv of max |x| "
              "from the in-order sums: " + ", ".join(
                  f"{'with' if redo else 'without'} the large P's sums "
                  "again " + "/".join(f"{x:.3g}" for x in e)
                  for redo, e in errs.items()))
    assert max(errs[True]) <= F32_TOL, errs
    assert max(errs[False]) > F32_TOL, errs


def test_one_tf32_term_breaks_the_bound():
    """Control: the products as one TF32 term (hi x hi) leave the bound the
    three terms keep, at unit scale."""
    q, k, v, dout = (torch.tensor(a) for a in
                     f32_inputs(1, 300, 4, 2, 64, 5))
    scale = 64 ** -0.5
    o, lse, want = plain_case(q, k, v, dout, scale)
    got = tf32x3_bwd_emulation(q, k, v, o, dout, lse, scale, kind="tf32")
    assert max(rel_max(a.numpy(), w.numpy())
               for a, w in zip(got, want)) > F32_TOL
