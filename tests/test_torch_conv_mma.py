"""The tensor-core conv layer (``csrc/conv_fused.cu``, K5: one launch a
stride-2 layer) on the CPU: its tiles read out of the source, the lane
addresses of its ldmatrix reads against the PTX fragment layouts and the
banks, a numpy emulation of its address arithmetic (the staged rows 2m + j,
the chunk permutation, the K slice loop, the zero fill past T_in and C, the
layer-0 norm in place, the masked stores) against the plain twin over
chains of 1-3 layers with ragged T and C, and where the launch counters
rise.

The CUDA kernel itself runs only on the card; ``chip_smoke.py`` holds it
against the plain twin there."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from wfl_asr_tpu_torch.ops.kernels import _build, conv_fused, \
    reset_launch_counts

SOURCE = Path(conv_fused.__file__).parent / "csrc" / "conv_fused.cu"
SMEM_LIMIT = 232448                 # shared memory a Hopper block may use


@pytest.fixture(scope="module", autouse=True)
def _setup():
    torch.set_num_threads(1)
    yield


def layer_tiles(f32: bool) -> dict:
    """Mirror of ``Cfg`` in ``csrc/conv_fused.cu``, with the per-dtype
    ``Tiles`` and the chunks a staged row read out of the source."""
    text = SOURCE.read_text()
    op = "OpF32" if f32 else "OpBF16"
    bm, bn, wn, stages, blocks = map(int, re.search(
        r"struct Tiles<%s> \{ static constexpr int bm = (\d+), bn = (\d+), "
        r"wn = (\d+), stages = (\d+), blocks = (\d+);" % op, text).groups())
    (row_chunks,) = map(int, re.search(r"constexpr int kRowChunks = (\d+);",
                                       text).groups())
    es = 4 if f32 else 2
    vec = 16 // es
    a_bytes = -(-((2 * bm + 2) // 2 * 128) // 1024) * 1024   # up to k = 3
    b_bytes = 3 * bn // 2 * 128
    ring = stages * (a_bytes + b_bytes)
    out_bytes = bm * (bn + 8) * 4                # f32 epilogue tile
    return dict(bm=bm, bn=bn, wn=wn, ni=bn // wn // 8, stages=stages,
                blocks=blocks, es=es, vec=vec, bk=row_chunks * vec,
                row_chunks=row_chunks, a_bytes=a_bytes, b_bytes=b_bytes,
                ring=ring, smem=max(ring, out_bytes),
                threads=32 * (bm // 64) * wn)


def swz(o):
    """``swz`` of the source: the permuted byte offset of unpermuted o."""
    return o ^ ((o >> 3) & 0x70)


def chunk_at(r, c):
    """Byte offset of chunk c of staged row r, as the layout is stated: rows
    2i and 2i + 1 share line i, its chunk positions XORed with i % 8."""
    line = r >> 1
    return (line << 7) | (((((r & 1) << 2) | c) ^ (line & 7)) << 4)


def test_swz_is_the_stated_layout():
    """``chunk_at(r, c) = swz(64·r + 16·c)`` for every row of a stage, and
    within a 1024-byte tile the permutation is a bijection on chunks."""
    r, c = np.meshgrid(np.arange(2 * 128 + 2), np.arange(4), indexing="ij")
    np.testing.assert_array_equal(swz(64 * r + 16 * c), chunk_at(r, c))
    o = 16 * np.arange(4096)
    assert sorted(swz(o)) == list(o)
    assert (swz(o + 1024) == swz(o) + 1024).all()


@pytest.mark.parametrize("f32", [True, False])
def test_layer_tiles(f32):
    """The tiles the design states: 8 warps of 64 rows, bf16 blocks of 128
    × 256 (warps of 64 × 64) in a 3-stage ring of 195 KB, f32 blocks of
    128 × 128 (warps of 64 × 32, the fresh sums doubling the accumulators)
    in a 4-stage ring of 164 KB; 64-byte staged rows (32 bf16 or 16 f32
    channels a K slice), each tile of a stage on 1024 bytes; the ring also
    holds the epilogue tile; one block a SM."""
    t = layer_tiles(f32)
    assert (t["bm"], t["threads"], t["row_chunks"]) == (128, 256, 4)
    assert (t["bn"], t["ni"], t["stages"], t["ring"]) == \
        ((128, 4, 4, 167936) if f32 else (256, 8, 3, 199680))
    assert t["a_bytes"] % 1024 == 0 and t["b_bytes"] % 1024 == 0
    assert t["bk"] * t["es"] == 64
    assert t["smem"] == t["ring"] <= SMEM_LIMIT
    assert t["blocks"] == 1 and t["threads"] % t["row_chunks"] == 0


def ldsm_x4(img: np.ndarray, addrs: np.ndarray) -> np.ndarray:
    """``ldmatrix.x4`` (not transposed) on a byte image of shared memory:
    lane l gives the row address of matrix l // 8; lane (g, t) receives the
    32 bits at row g, 16-bit columns 2t and 2t + 1 of each matrix."""
    assert (addrs % 16 == 0).all()
    rows = np.stack([img[a:a + 16] for a in addrs]).view(np.uint32)  # [32, 4]
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    return np.stack([rows[8 * i + g, t] for i in range(4)], axis=1)


def conflict_free(addrs: np.ndarray) -> bool:
    """Each matrix's 8 row addresses (one shared-memory phase) fall on 8
    distinct 16-byte bank groups."""
    return all(len(set((addrs[8 * i:8 * i + 8] // 16) % 8)) == 8
               for i in range(4))


def a_addrs(f32: bool, m0: int, j: int, ks: int) -> np.ndarray:
    """``load_a``'s lane addresses (output rows m0.., tap j, k-step ks):
    swz(a_lane + 128·m0 + 64·j + 32·ks)."""
    lane = np.arange(32)
    m = lane >> 3
    a_lane = 128 * ((lane & 7) + 8 * (m & 1)) + 16 * (m >> 1) if f32 \
        else 128 * (lane & 15) + 16 * (lane >> 4)
    return swz(a_lane + 128 * m0 + 64 * j + 32 * ks)


def b_addrs(f32: bool, r0: int, ks: int) -> np.ndarray:
    """``load_b2``'s lane addresses (weight rows r0.., k-step ks):
    swz(b_lane + 64·r0 + 32·ks)."""
    lane = np.arange(32)
    m = lane >> 3
    b_lane = 64 * ((lane & 7) + 8 * (m >> 1)) + 16 * (m & 1) if f32 \
        else 64 * ((lane & 7) + ((lane >> 4) << 3)) + 16 * ((lane >> 3) & 1)
    return swz(b_lane + 64 * r0 + 32 * ks)


def a_from_regs(f32: bool, regs: np.ndarray) -> np.ndarray:
    """The A matrix that the mma reads from the lanes' registers (PTX ISA
    fragment layouts): m16n8k16 bf16 [16, 16] of 16-bit values, m16n8k8
    TF32 [16, 8] of 32-bit values."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    if f32:
        a = np.zeros((16, 8), np.uint32)
        for i, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 4), (8, 4))):
            a[g + dr, t + dk] = regs[:, i]
        return a
    a = np.zeros((16, 16), np.uint32)
    for i, (dr, dk) in enumerate(((0, 0), (8, 0), (0, 8), (8, 8))):
        a[g + dr, 2 * t + dk] = regs[:, i] & 0xFFFF
        a[g + dr, 2 * t + dk + 1] = regs[:, i] >> 16
    return a


def b_from_regs(f32: bool, r0: np.ndarray, r1: np.ndarray) -> np.ndarray:
    """The B matrix [k, 8] of one n-tile from its two registers a lane."""
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    if f32:
        b = np.zeros((8, 8), np.uint32)
        b[t, g], b[t + 4, g] = r0, r1
        return b
    b = np.zeros((16, 8), np.uint32)
    for r, dk in ((r0, 0), (r1, 8)):
        b[2 * t + dk, g] = r & 0xFFFF
        b[2 * t + dk + 1, g] = r >> 16
    return b


@pytest.mark.parametrize("k", [2, 3])
@pytest.mark.parametrize("f32", [True, False])
def test_fragments_read_stride2_rows_without_conflicts(f32, k):
    """Every fragment read of one K slice, for every warp, tap and k-step,
    emulated lane by lane on a stage image whose elements are their own
    (row, column) ids: the A fragment of tap j holds staged rows 2m + j of
    the warp's output rows, the B fragments the weight rows of tap j and
    the warp's output channels, each at the slice's columns; and each
    ldmatrix phase (eight rows two apart for A, eight consecutive for B)
    falls on eight distinct 16-byte bank groups."""
    t = layer_tiles(f32)
    bm, bn, bk, es = t["bm"], t["bn"], t["bk"], t["es"]
    kstep = 8 if f32 else 16                  # k depth of one mma
    n_a, n_b = 2 * bm + k - 2, k * bn
    ids = np.uint32 if f32 else np.uint16

    def image(n_rows, base):
        img = np.zeros(max(t["a_bytes"], t["b_bytes"]), np.uint8)
        for r in range(n_rows):
            for c in range(t["row_chunks"]):
                v = (base + r * bk + c * t["vec"]
                     + np.arange(t["vec"])).astype(ids)
                img[chunk_at(r, c):chunk_at(r, c) + 16] = v.view(np.uint8)
        return img
    img_a, img_b = image(n_a, 0), image(n_b, 40000)
    assert es * t["vec"] == 16
    wcols = 8 * t["ni"]                       # channels a warp
    for wm in range(bm // 64):
        for wn in range(t["wn"]):
            for j in range(k):
                for ks in range(bk // kstep):
                    for mi in range(4):
                        m0 = 64 * wm + 16 * mi
                        addrs = a_addrs(f32, m0, j, ks)
                        assert conflict_free(addrs), (wm, j, ks, mi)
                        a = a_from_regs(f32, ldsm_x4(img_a, addrs))
                        rows = 2 * (m0 + np.arange(16)) + j
                        want = rows[:, None] * bk + ks * kstep \
                            + np.arange(kstep)[None, :]
                        np.testing.assert_array_equal(a, want)
                    for half in range(t["ni"] // 2):
                        r0 = j * bn + wcols * wn + 16 * half
                        addrs = b_addrs(f32, r0, ks)
                        assert conflict_free(addrs), (wn, j, ks, half)
                        regs = ldsm_x4(img_b, addrs)
                        for nt in range(2):
                            b = b_from_regs(f32, regs[:, 2 * nt],
                                            regs[:, 2 * nt + 1])
                            rows = r0 + 8 * nt + np.arange(8)
                            want = 40000 + rows[None, :] * bk \
                                + ks * kstep + np.arange(kstep)[:, None]
                            np.testing.assert_array_equal(b, want)


def test_plain_row_major_tile_would_conflict():
    """What the permutation is for: in a plain row-major tile of 64- or
    128-byte rows, the eight stride-2 rows of one A phase start on one
    16-byte bank group (an 8-way conflict); permuted, on eight."""
    rows = 2 * np.arange(8)
    assert len(set(((rows * 64) // 16) % 8)) == 1      # 64-byte rows
    assert len(set(((rows * 128) // 16) % 8)) == 1     # 128-byte rows
    assert len(set((chunk_at(rows, 0) // 16) % 8)) == 8


def _gelu(x: np.ndarray) -> np.ndarray:
    return F.gelu(torch.from_numpy(x.astype(np.float32))).numpy()


def emulate_layer(x: np.ndarray, wp: np.ndarray, norm, f32_tiles: bool
                  ) -> np.ndarray:
    """One launch of ``conv_layer_mma`` in numpy, in f32 values, block by
    block and K slice by K slice as the kernel walks them: ``Stager::copy``
    (each thread's 16-byte chunks into the permuted stage image at its
    precomputed offsets, zero where the row is at or past T_in or the
    channel at or past C), ``Stager::norm`` (each thread's own chunks, in
    place, rows below T_in and channels below C), the products of every
    tap read back from staged rows 2m + j, and the epilogue's stores at
    the kernel's flat offsets, only where row < T_out and channel < C.
    ``f32_tiles`` picks the tile geometry (16 or 32 channels a slice).
    Every output element must be written exactly once."""
    t = layer_tiles(f32_tiles)
    bm, bn, bk, vec, rc = t["bm"], t["bn"], t["bk"], t["vec"], \
        t["row_chunks"]
    rp = t["threads"] // rc                      # rows a pass of copies
    n_b, t_in, c = x.shape
    k = wp.shape[0]
    t_out = (t_in - k) // 2 + 1
    n_a = 2 * bm + k - 2
    flat = np.zeros(n_b * t_out * c, np.float32)
    hits = np.zeros(n_b * t_out * c, np.int64)
    kt_n = -(-c // bk)
    for b in range(n_b):
        for mt in range(-(-t_out // bm)):
            for nt in range(-(-c // bn)):                   # fastest
                m0, n0 = mt * bm, nt * bn
                in0 = 2 * m0
                acc = np.zeros((bm, bn), np.float64)
                for kt in range(kt_n):
                    c0 = kt * bk
                    img_a = np.full((t["a_bytes"] // 16, vec), np.nan)
                    img_b = np.full((t["b_bytes"] // 16, vec), np.nan)
                    # Stager::copy, thread by thread: chunk column
                    # tid % 4, rows tid / 4 + RP·i at chunk_at(tid / 4,
                    # tid % 4) + 64·RP·i
                    for tid in range(t["threads"]):
                        r0, cc = divmod(tid, rc)
                        ch = c0 + cc * vec
                        dst = chunk_at(r0, cc)
                        for i in range(-(-n_a // rp)):
                            r = r0 + rp * i
                            if r >= n_a:
                                break
                            ok = in0 + r < t_in and ch < c
                            img_a[(dst + 64 * rp * i) // 16] = \
                                x[b, in0 + r, ch:ch + vec] if ok else 0.0
                        for i in range(k * bn // rp):
                            j, nn = divmod(i * rp, bn)
                            ok = n0 + r0 + nn < c and ch < c
                            img_b[(dst + 64 * rp * i) // 16] = \
                                wp[j, n0 + r0 + nn, ch:ch + vec] if ok \
                                else 0.0
                    if norm is not None:          # Stager::norm
                        mean, inv, scale, bias = norm
                        for tid in range(t["threads"]):
                            r0, cc = divmod(tid, rc)
                            ch = c0 + cc * vec
                            if ch >= c:
                                continue
                            s = slice(ch, ch + vec)
                            for i in range(-(-n_a // rp)):
                                r = r0 + rp * i
                                if r >= n_a or in0 + r >= t_in:
                                    break
                                at = (chunk_at(r0, cc) + 64 * rp * i) // 16
                                y = ((img_a[at].astype(np.float32)
                                      - mean[b, s]) * inv[b, s])
                                img_a[at] = _gelu(y * scale[s] + bias[s])
                    cols = np.arange(bk)
                    for j in range(k):
                        rows_a = 2 * np.arange(bm)[:, None] + j
                        a = img_a[chunk_at(rows_a, cols[None] // vec) // 16,
                                  cols[None] % vec]
                        rows_b = j * bn + np.arange(bn)[:, None]
                        w = img_b[chunk_at(rows_b, cols[None] // vec) // 16,
                                  cols[None] % vec]
                        acc += a @ w.T
                g = _gelu(acc)
                r, cc = np.meshgrid(np.arange(bm), np.arange(bn),
                                    indexing="ij")
                keep = (m0 + r < t_out) & (n0 + cc < c)
                at = ((b * t_out + m0) * c + n0) + r * c + cc
                np.add.at(hits, at[keep], 1)
                flat[at[keep]] = g[keep]
    assert (hits == 1).all(), "every output element stored exactly once"
    return flat.reshape(n_b, t_out, c)


CASES = [
    # (kernel sizes, T_in, C, input norm): 2 N-tiles, 3 M-tiles, ragged
    ((3,), 601, 144, True),
    ((2,), 258, 48, False),        # T_out 129: a second M-tile of one row
    ((3, 3), 333, 80, True),
    ((3, 2, 2), 700, 16, False),
    ((3, 3, 3), 1100, 48, True),   # every layer over several M-tiles
]


@pytest.mark.parametrize("f32_tiles", [True, False])
@pytest.mark.parametrize("ks,t_in,c,has_norm", CASES)
def test_emulated_layers_match_plain_twin(ks, t_in, c, has_norm, f32_tiles):
    """The chain as ``fused_conv_chain`` launches it on the card, one
    emulated layer at a time in the tile geometry of either dtype, with the
    weights from :func:`pack_weights`, against :func:`conv_chain_plain` in
    f32: ragged T (odd, and M-tiles of one row), C not a multiple of the
    K slice or of the N tile, the norm on the first layer only."""
    rng = np.random.RandomState(sum(ks) + t_in + c)
    b = 2
    x = (rng.randn(b, t_in, c) * 0.5).astype(np.float32)
    ws = [torch.from_numpy((rng.randn(c, c, k) / np.sqrt(c * k))
                           .astype(np.float32)) for k in ks]
    norm = None
    if has_norm:
        norm = (rng.randn(b, c).astype(np.float32) * 0.1,
                (0.5 + rng.rand(b, c)).astype(np.float32),
                (1.0 + 0.2 * rng.randn(c)).astype(np.float32),
                (rng.randn(c) * 0.1).astype(np.float32))
    want = conv_fused.conv_chain_plain(
        torch.from_numpy(x), ws,
        None if norm is None else tuple(map(torch.from_numpy, norm))).numpy()
    h = x
    for i, wp in enumerate(conv_fused.pack_weights(ws, torch.float32)):
        h = emulate_layer(h, wp.numpy(), norm if i == 0 else None, f32_tiles)
    assert h.shape == want.shape
    np.testing.assert_allclose(h, want, atol=1e-5, rtol=0)


def test_pack_weights_layout():
    """[C_out, C_in, k] → [k, C_out, C_in] in the asked dtype, contiguous."""
    w = torch.randn(16, 16, 3)
    (p,) = conv_fused.pack_weights([w], torch.bfloat16)
    assert p.dtype == torch.bfloat16 and p.is_contiguous()
    assert tuple(p.shape) == (3, 16, 16)
    torch.testing.assert_close(p.float(), w.permute(2, 0, 1).bfloat16()
                               .float())


@pytest.mark.parametrize("err", [0, 2])
@pytest.mark.parametrize("has_norm", [True, False])
def test_layer_launches_counted_where_they_launch(monkeypatch, err,
                                                  has_norm):
    """``layer_launches`` rises once a layer, after the library of
    ``conv_fused.cu`` ran its launcher with no error, and not when the
    launch failed; each launch gets the layer's own T_in, T_out and k, and
    the norm's four pointers on the first layer only. (A stand-in library
    takes the launches on the CPU.)"""
    libs, calls = [], []

    class Library:
        def __getattr__(self, name):
            if name == "wfl_error_string":
                return lambda code: b"invalid argument"
            assert name == "wfl_conv_layer_fwd"
            return lambda *args: calls.append(args) or err
    monkeypatch.setattr(_build, "library",
                        lambda name: libs.append(name) or Library())
    monkeypatch.setattr(_build, "stream_ptr", lambda device: 0)
    reset_launch_counts()
    c = 16
    x = torch.randn(2, 95, c)
    ws = [torch.randn(c, c, k) for k in (3, 2, 2)]
    packed = conv_fused.pack_weights(ws, torch.float32)
    norm = [torch.zeros(2, c), torch.ones(2, c), torch.ones(c),
            torch.zeros(c)] if has_norm else None
    if err:
        with pytest.raises(_build.KernelBuildError, match="invalid"):
            conv_fused._launch_layers(x, packed, norm)
        assert conv_fused.layer_launches == 0 and len(calls) == 1
        return
    out = conv_fused._launch_layers(x, packed, norm)
    assert libs == ["conv_fused"]
    assert tuple(out.shape) == (2, conv_fused.chain_out_len(95, (3, 2, 2)),
                                c)
    assert [a[3:8] for a in calls] == [(2, 95, 47, c, 3), (2, 47, 23, c, 2),
                                       (2, 23, 11, c, 2)]
    assert all((a[8] is not None) == (has_norm and i == 0)
               for i, a in enumerate(calls))
    assert all(a[12] == 0 for a in calls)                     # f32
    assert [a[0] for a in calls[1:]] == [a[2] for a in calls[:-1]]
    assert conv_fused.layer_launches == 3
    assert not conv_fused.launches        # the chain's count: entry point
