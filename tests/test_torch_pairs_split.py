"""The plain pieces of the pair kernel's item decomposition (subset and
ray-bundle modes of `csrc/pairs_kernel.cu`): the 64-bit key whose order
is the order of (ts, k mod 8, k), the code-free walk over a piece of a
span, the merge by minimum and the finish that reads the winner's
column. Cut into items of any size and merged in any order they must
give `_walk_pairs` — the definition of the function — bit for bit; the
CUDA kernel is held against the same plain versions on the card by
`chip_smoke.py`. Every comparison within the port is exact, the sign of
a zero included. One case holds the tie rule across items directly
against the reference package's Pallas kernel (interpret mode), whose
winner must be the same on every ray."""

import numpy as np
import pytest
import torch

from sphereflake_tpu_torch.config import RenderConfig
from sphereflake_tpu_torch.config import default_scene
from sphereflake_tpu_torch.models import sphereflake as model
from sphereflake_tpu_torch.ops import binned

import _torch_helpers  # noqa: F401  (one torch thread per test worker)

_BIG = np.float32(3.0e38)
_ITEM_SIZES = [1, 7, 8, 64, 256]


def _bits(x):
    return x.contiguous().view(torch.int32)


def _assert_same_winner(got, want):
    """All six winner planes equal, t down to the sign of a zero."""
    for name, g, w in zip(("t", "lo", "hi", "cx", "cy", "cz"), got, want):
        assert torch.equal(_bits(g), _bits(w)), name


# ---- the key --------------------------------------------------------


def _tuple_less(ts_a, k_a, ts_b, k_b):
    """(ts, k mod 8, k) of a before that of b, with f32 `<` and `==` on
    ts (so -0.0 and +0.0 tie), as the plain walk compares."""
    a = (k_a & 7, k_a)
    b = (k_b & 7, k_b)
    low = (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] < b[1]))
    return (ts_a < ts_b) | ((ts_a == ts_b) & low)


_SPECIAL_TS = np.asarray(
    [0.0, -0.0, 1.0, -1.0, 7.1747, np.nextafter(np.float32(7.1747), 8),
     1e-45, -1e-45, 1.17549435e-38, -3.0e38, 2.9e38, -np.inf, 1e-3],
    np.float32,
)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_key_order_is_the_order_of_ts_then_k_mod_8_then_k(seed):
    rng = np.random.default_rng(seed)
    n = 4096
    ts = rng.normal(size=n).astype(np.float32) * np.float32(10.0) ** rng.integers(
        -6, 6, n
    ).astype(np.float32)
    ts[: n // 4] = rng.choice(_SPECIAL_TS, n // 4)  # many equal ts, +-0, ...
    ts[n // 4: n // 2] = rng.choice(ts[n // 2:], n // 4)  # ties with others
    k = rng.integers(0, 1 << 12, n)
    k[::7] = rng.integers(0, binned.MAX_KEYED_PAIR_CAP, len(k[::7]))
    k[::11] = binned.MAX_KEYED_PAIR_CAP - 1  # the largest position there is
    ts[0], ts[1], k[0], k[1] = 0.0, -0.0, 5, 5  # one key for the two zeros
    a, b = rng.permutation(n), rng.permutation(n)
    b[:64] = a[:64]  # an element against itself
    a[64], b[64] = 0, 1
    ts_t, k_t = torch.from_numpy(ts), torch.from_numpy(k.astype(np.int64))
    key = binned._winner_key(ts_t, k_t)
    assert key.dtype == torch.int64
    want = _tuple_less(ts_t[a], k_t[a], ts_t[b], k_t[b])
    assert torch.equal(key[a] < key[b], want)
    same = (ts_t[a] == ts_t[b]) & (k_t[a] == k_t[b])
    assert torch.equal(key[a] == key[b], same)
    assert bool(want.any()) and bool(same.any()) and bool((~want & ~same).any())
    # "No candidate" comes after every key there can be.
    assert bool((key < binned._EMPTY_KEY).all())


def test_key_of_special_values():
    ts = torch.from_numpy(_SPECIAL_TS)
    key = binned._winner_key(ts, 5)
    order = np.argsort(key.numpy(), kind="stable")
    assert (np.diff(_SPECIAL_TS[order]) >= 0).all()
    # +-0.0 get one key; the empty key is the kernel's all-ones word with
    # the top bit flipped, and its low word reads as "no candidate".
    assert int(key[0]) == int(key[1])
    assert binned._EMPTY_KEY == (1 << 63) - 1
    assert binned._EMPTY_KEY & 0xFFFFFFFF == 0xFFFFFFFF
    top = binned._winner_key(torch.tensor([2.9e38]), binned.MAX_KEYED_PAIR_CAP - 1)
    assert int(top) & 0xFFFFFFFF != 0xFFFFFFFF


# ---- split walk + merge + finish == the whole walk --------------------


def _random_table(seed, deep, lens):
    """A seeded pair table of spheres in front of a camera at the origin
    looking down -z (a third of them copies of an earlier column under
    another code: exact ties in t), spans that overlap, and one bundle of
    1024 rays per span."""
    rng = np.random.default_rng(seed)
    n_rows = 8 if deep else 7
    r_lodr, r_rc4 = (6, 7) if deep else (5, 6)
    cap = 640
    c = np.stack([rng.uniform(-2, 2, cap), rng.uniform(-2, 2, cap),
                  rng.uniform(-9, -4, cap)]).astype(np.float32)
    r = rng.uniform(0.05, 0.6, cap).astype(np.float32)
    copies = rng.random(cap) < 1 / 3
    src = rng.integers(0, cap, cap)
    c[:, copies], r[copies] = c[:, src[copies]], r[src[copies]]
    cc = (c * c).sum(0, dtype=np.float32)
    pairs = np.zeros((n_rows, cap), np.float32)
    pairs[0:3] = c
    pairs[3] = r * r - cc
    pairs[4] = np.arange(1, cap + 1, dtype=np.float32)
    if deep:
        pairs[5] = np.arange(cap, 0, -1, dtype=np.float32)
    # A third of the spheres are cut by the LOD gate on part of their rays.
    pairs[r_lodr] = np.where(rng.random(cap) < 1 / 3, 0.9, 4900.0) * r
    pairs[r_rc4] = np.float32(4.0) * r * r - cc
    lens = np.asarray(lens, np.int32)
    starts = rng.integers(0, cap - lens.max() + 1, len(lens)).astype(np.int32)
    d = rng.normal(size=(len(lens), 3, 1024)).astype(np.float32) * 0.25
    d[:, 2] = -1.0
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    dirs = torch.from_numpy(d.astype(np.float32))
    return (dirs[:, 0], dirs[:, 1], dirs[:, 2], torch.from_numpy(pairs),
            torch.from_numpy(starts), torch.from_numpy(lens))


@pytest.mark.parametrize("deep", [False, True], ids=["shallow", "deep"])
@pytest.mark.parametrize("item_pairs", _ITEM_SIZES)
def test_split_walk_equals_whole_walk_on_seeded_tables(item_pairs, deep):
    """Spans of 0, 1, one item exactly, one more, and several items."""
    lens = [0, 1, item_pairs, item_pairs + 1, 2 * item_pairs + 16, 300]
    args = _random_table(10 * item_pairs + deep, deep, lens)
    whole = binned._walk_pairs(*args, deep)
    split = binned._walk_pairs_split(*args, deep, item_pairs)
    _assert_same_winner(split, whole)
    hit = whole[1] >= 1
    assert 0.05 < float(hit[1:].float().mean()) < 0.95 and not bool(hit[0].any())
    # Code-free: the same winner's centre, codes left at 0.
    bare = binned._walk_pairs_split(*args, deep, item_pairs, codes=False)
    want = binned._walk_pairs(*args, deep, codes=False)
    _assert_same_winner(bare, want)
    assert not bool(bare[1].any()) and bool(bare[3].any())


@pytest.mark.parametrize("shade_only", [True, False], ids=["shade_only", "coded"])
@pytest.mark.parametrize("item_pairs", [7, 64])
def test_split_walk_gives_the_subset_rows_of_a_scene(item_pairs, shade_only):
    """On the port's own pair table: raygen + split walk + shading equal
    the subset mode's plain version, rows and all."""
    cfg = RenderConfig(width=128, height=64, max_depth=3, tile_h=32, tile_w=32,
                       algorithm="binned")
    scene = default_scene("cpu")
    pairs, starts, lens, _ = binned.binned_pairs(
        scene, cfg, model.root_frame(scene.camera.position),
        model.child_templates(scene.fractal),
    )
    assert int(lens.max()) > 64  # more than one item somewhere
    cam = binned.camera_vector(scene, cfg)
    ids = torch.tensor([5, 1, 6, 5, 2], dtype=torch.int32)
    want, _ = binned.trace_pairs_fused_subset_plain(
        cam, pairs, starts, lens, ids, cfg, shade_only=shade_only
    )
    dx, dy, dz = binned._tile_raygen(cam, ids, cfg)
    winner = binned._walk_pairs_split(
        dx, dy, dz, pairs, starts[ids.long()], lens[ids.long()], False,
        item_pairs, codes=not shade_only,
    )
    got = binned._shade_rows(dx, dy, dz, winner, False, shade_only=shade_only)
    assert torch.equal(_bits(got), _bits(want))
    assert 0.05 < float((want[:, 0] < 1e38).float().mean())


@pytest.mark.parametrize("deep", [False, True], ids=["shallow", "deep"])
def test_split_walk_gives_the_full_grid_rows_of_a_scene(deep):
    """The full-grid mode is the item walk over every tile of the frame:
    raygen + split walk at the kernel's item size + shading equal the
    full grid's plain version, rows and all, shallow (depth 3) and deep
    (depth 7, two code rows; a LOD factor of 20 keeps its segments
    within a few hundred pairs)."""
    cfg = RenderConfig(width=128, height=64, max_depth=7 if deep else 3,
                       tile_h=32, tile_w=32, algorithm="binned",
                       lod_factor=20.0 if deep else 70.0)
    scene = default_scene("cpu")
    pairs, starts, lens, _ = binned.binned_pairs(
        scene, cfg, model.root_frame(scene.camera.position),
        model.child_templates(scene.fractal),
    )
    assert int(lens.max()) > binned.ITEM_PAIRS
    cam = binned.camera_vector(scene, cfg)
    want, want_m = binned.trace_pairs_fused_plain(cam, pairs, starts, lens, cfg)
    tid = torch.arange(cfg.tiles_x * cfg.tiles_y, dtype=torch.int32)
    dx, dy, dz = binned._tile_raygen(cam, tid, cfg)
    winner = binned._walk_pairs_split(
        dx, dy, dz, pairs, starts, lens, deep, binned.ITEM_PAIRS
    )
    got = binned._shade_rows(dx, dy, dz, winner, deep)
    assert got.shape[1] == (9 if deep else 8)
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(want_m[:, 0, 0], lens)
    assert 0.05 < float((want[:, 1] >= 1).float().mean()) < 0.95


# ---- exact ties across item boundaries --------------------------------

# Camera at the origin looking down -z over a 32x32 frame (the pack of
# `camera_vector`: tl, ex, ey, origin, x_off, y_off, frame_w, frame_h).
_CAM = np.asarray(
    [-0.5, 0.5, -1.0, 1.0, 0.0, 0.0, 0.0, -1.0, 0.0, 0.0, 0.0, 0.0,
     0.0, 0.0, 32.0, 32.0], np.float32,
)
# The same sphere (mirrored: +x at odd places of this list, -x at even) at
# span positions whose k mod 8 runs against k: 7 and 263 (-x) are chain 7,
# 66 (-x) chain 2, 9 (+x) chain 1, 136 (+x) chain 0 (the winner, in the
# third item of 64), 520 (+x) chain 0 but later.
_TIE_KS = [7, 9, 66, 136, 263, 520]


def _tie_span(span_start=3, span_len=530):
    pairs = np.zeros((7, span_start + span_len + 5), np.float32)
    pairs[3] = -_BIG  # fillers: disc < 0 always

    def put(k, c, r, code):
        c = np.asarray(c, np.float32)
        cc, r2 = np.float32(np.dot(c, c)), np.float32(r * r)
        col = span_start + k
        pairs[0:3, col] = c
        pairs[3, col] = r2 - cc
        pairs[4, col] = code
        pairs[5, col] = np.float32(4900.0) * np.float32(r)
        pairs[6, col] = np.float32(4.0) * r2 - cc

    for i, k in enumerate(_TIE_KS):
        if k < span_len:
            put(k, [0.75 if i % 2 else -0.75, 0.0, -5.0], 1.0, 1000.0 + k)
    put(min(300, span_len - 1), [0.3, 0.2, -3.0], 0.2, 1300.0)  # nearer, no tie
    starts = np.asarray([span_start], np.int32)
    lens = np.asarray([span_len], np.int32)
    return pairs, starts, lens


@pytest.mark.parametrize("item_pairs", _ITEM_SIZES)
def test_exact_ties_across_items_go_to_smallest_k_mod_8_then_k(item_pairs):
    """Pixel column 16 has dx == 0 exactly, so its rays meet the six
    mirrored copies at exactly the same t, wherever the items are cut:
    the copy at k = 136 (chain 0) wins over earlier positions in later
    chains and over 520 (chain 0, later); the whole walk says the same."""
    pairs, starts, lens = _tie_span()
    cfg = RenderConfig(width=32, height=32, tile_h=32, tile_w=32,
                       algorithm="binned", max_depth=3)
    cam, pairs_t = torch.from_numpy(_CAM), torch.from_numpy(pairs)
    starts_t, lens_t = torch.from_numpy(starts), torch.from_numpy(lens)
    tid = torch.zeros(1, dtype=torch.int32)
    dx, dy, dz = binned._tile_raygen(cam, tid, cfg)
    assert bool((dx.reshape(32, 32)[:, 16] == 0).all())
    split = binned._walk_pairs_split(
        dx, dy, dz, pairs_t, starts_t, lens_t, False, item_pairs
    )
    whole = binned._walk_pairs(dx, dy, dz, pairs_t, starts_t, lens_t, False)
    _assert_same_winner(split, whole)
    code = split[1].reshape(32, 32)[:, 16]
    hit = code >= 1
    assert int(hit.sum()) >= 8
    assert set(code[hit].tolist()) == {1136.0}
    assert bool((split[3].reshape(32, 32)[:, 16][hit] == 0.75).all())
    # Off the tie column the nearer of the two mirrored spheres wins, by
    # its first copy in the order: chain 0 (k = 136) for +x, chain 2 (66)
    # for -x; the small sphere in front wins where it is hit.
    assert {1066.0, 1136.0, 1300.0} <= set(split[1].unique().tolist())
    assert not {1007.0, 1009.0, 1263.0, 1520.0} & set(split[1].unique().tolist())
    # The subset wrapper's plain version agrees, shading included.
    rows, _ = binned.trace_pairs_fused_subset(
        cam, pairs_t, starts_t, lens_t, tid, cfg, shade_only=True
    )
    got = binned._shade_rows(dx, dy, dz, binned._walk_pairs_split(
        dx, dy, dz, pairs_t, starts_t, lens_t, False, item_pairs, codes=False
    ), False, shade_only=True)
    assert torch.equal(_bits(got), _bits(rows))
    assert bool((rows[0, 4].reshape(32, 32)[:, 16][hit] < -0.5).all())  # nx


@pytest.mark.parametrize("span_len", [2 * binned.ITEM_PAIRS + 16, 530])
def test_ties_across_items_match_the_reference_pallas_kernel(span_len):
    """The mirrored-sphere span through the reference package's
    ray-bundle kernel, whose eight accumulator chains define the tie
    rule: the split walk at the kernel's item size and the plain
    ray-bundle version pick its winner on every ray — code and centre
    exactly — and 136 on the tie column, where dx == 0 makes the copies'
    t equal under any rounding. t itself is held to 1e-5: XLA's CPU
    backend contracts multiply-adds, the port does not."""
    import jax.numpy as jnp

    from sphereflake_tpu.config import RenderConfig as RefConfig
    from sphereflake_tpu.ops import binned as ref_binned

    pairs, starts, lens = _tie_span(span_len=span_len)
    kw = dict(width=32, height=32, tile_h=32, tile_w=32, algorithm="binned",
              max_depth=3)
    cfg = RenderConfig(**kw)
    pairs_t = torch.from_numpy(pairs)
    starts_t, lens_t = torch.from_numpy(starts), torch.from_numpy(lens)
    dx, dy, dz = binned._tile_raygen(
        torch.from_numpy(_CAM), torch.zeros(1, dtype=torch.int32), cfg
    )
    dirs_k = torch.stack([dx, dy, dz], dim=1).reshape(1, 3, 8, 128)
    want, want_m = ref_binned.trace_pairs_pallas_soa(
        jnp.asarray(dirs_k.numpy()), jnp.asarray(pairs), jnp.asarray(starts),
        jnp.asarray(lens), RefConfig(**kw), interpret=True,
    )
    want = torch.from_numpy(np.array(want)).reshape(5, 1024)
    plain, plain_m = binned.trace_pairs_pallas_soa_plain(
        dirs_k, pairs_t, starts_t, lens_t, cfg
    )
    assert np.array_equal(plain_m.numpy(), np.asarray(want_m))
    bt, blo, _, bcx, bcy, bcz = binned._walk_pairs_split(
        dx, dy, dz, pairs_t, starts_t, lens_t, False, binned.ITEM_PAIRS
    )
    split = torch.stack([bt, blo, bcx, bcy, bcz], dim=1).reshape(5, 1024)
    for got in (split, plain.reshape(5, 1024)):
        assert torch.equal(_bits(got[1:]), _bits(want[1:]))
        assert torch.allclose(got[0], want[0], rtol=1e-5, atol=1e-5)
    code = want[1].reshape(32, 32)[:, 16]
    assert int((code >= 1).sum()) >= 8
    assert set(code[code >= 1].tolist()) == {1136.0}
    in_span = {1000.0 + k for k in _TIE_KS if k < span_len}
    assert set(want[1].unique().tolist()) & in_span == {1066.0, 1136.0}


@pytest.mark.parametrize("minus_first", [True, False],
                         ids=["minus_zero_first", "plus_zero_first"])
def test_minus_zero_ties_with_plus_zero_and_keeps_its_sign(minus_first):
    """A point sphere at the origin: every product of a direction
    component with +0 has that component's sign, so all-negative
    directions give tca = -0.0 and t = -0.0, and against a centre of -0s
    tca = t = +0.0. `==` ties the two; (k mod 8, k) decides (k = 9,
    chain 1, before k = 3, chain 3), and the winner's own sign comes
    out — also when the two sit in different items."""
    pairs = np.zeros((7, 16), np.float32)
    pairs[3] = -_BIG
    k_minus, k_plus = (9, 3) if minus_first else (3, 9)
    for k, zero, code in ((k_minus, 0.0, 21.0), (k_plus, -0.0, 22.0)):
        pairs[0:3, k] = zero
        pairs[3, k] = 0.0   # r = 0: disc = tca^2
        pairs[4, k] = code
        pairs[6, k] = 1.0   # the LOD gate passes
    d = -np.abs(np.random.default_rng(4).normal(size=(1, 3, 1024)))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    dirs = torch.from_numpy(d)
    args = (dirs[:, 0], dirs[:, 1], dirs[:, 2], torch.from_numpy(pairs),
            torch.zeros(1, dtype=torch.int32),
            torch.full((1,), 12, dtype=torch.int32))
    whole = binned._walk_pairs(*args, False)
    assert bool((whole[0] == 0).all())
    assert bool((whole[1] == (21.0 if minus_first else 22.0)).all())
    assert bool((torch.signbit(whole[0]) == minus_first).all())
    for item_pairs in (1, 4, 8, 64):
        _assert_same_winner(
            binned._walk_pairs_split(*args, False, item_pairs), whole
        )


# ---- the wrappers' limit ---------------------------------------------


def test_pair_cap_limit_is_the_keys_field():
    assert binned.MAX_KEYED_PAIR_CAP == (1 << 29) - 1
    binned._check_keyed_pair_cap(binned.MAX_KEYED_PAIR_CAP)
    with pytest.raises(ValueError, match="29-bit"):
        binned._check_keyed_pair_cap(binned.MAX_KEYED_PAIR_CAP + 1)


@pytest.mark.parametrize("mode", ["full", "subset", "subset_shade_only", "dirs"])
def test_wrapper_raises_when_pair_cap_exceeds_the_keys_field(mode):
    """Tensors without storage (`meta`) stand in for a table of 2^29
    columns; one column fewer passes the check."""
    cfg = RenderConfig(width=64, height=32, tile_h=32, tile_w=32,
                       algorithm="binned", max_depth=2)

    def meta(shape, dtype=torch.float32):
        return torch.empty(shape, dtype=dtype, device="meta")

    def call(pair_cap):
        pairs = meta((7, pair_cap))
        if mode == "full":
            return binned.trace_pairs_fused_soa(
                meta((16,)), pairs, meta((2,), torch.int32),
                meta((2,), torch.int32), cfg,
            )
        if mode == "dirs":
            return binned.trace_pairs_pallas_soa(
                meta((3, 3, 8, 128)), pairs, meta((3,), torch.int32),
                meta((3,), torch.int32), cfg,
            )
        return binned.trace_pairs_fused_subset(
            meta((16,)), pairs, meta((2,), torch.int32),
            meta((2,), torch.int32), meta((3,), torch.int32), cfg,
            shade_only=mode == "subset_shade_only",
        )

    with pytest.raises(ValueError, match="at most 536870911"):
        call(1 << 29)
    # Within the field the check passes; the call then goes on to the
    # plain version, which cannot run without storage.
    with pytest.raises(Exception) as info:
        call((1 << 29) - 1)
    assert "at most 536870911" not in str(info.value)
