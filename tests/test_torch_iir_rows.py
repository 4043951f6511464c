"""The IIR row kernel's two scan orders and the dt stage folded into it,
on CPU.

``csrc/iir.cu`` ``iir_rows_kernel`` gives each lane a run of 16 adjacent
elements and scans in one of two orders, every product and sum rounded
once:

* the plain row pass (``scan_rows``), :func:`_run_scan`: each lane
  composes its run's maps serially, a 5-step shift-and-compose scan over
  the 32 lanes composes one map per lane, each lane applies the carry of
  the lane before it along its run; a row past 512 elements is split into
  512-element chunks over up to 8 warps, whose aggregate maps are applied
  to the carry one after another, and past 4096 elements the spans of 8
  chunks follow each other with a carry;
* the dt stage (``dt_scan_rows``), :func:`_lane_pair_scan`: the PR 3
  kernel's order, chunks of 32 elements (a lane pair's runs), each
  composed by a 5-step Hillis-Steele scan in which the pair's second lane
  takes its partner's elements by shuffles, then applied to the previous
  chunk's last output; it equals tests/test_torch_iir_taper.py's
  ``_chunked_scan`` (the column kernel's order) bit for bit.

The backward pass runs each order from the row's end. Both are held to the
JAX package's ``iir_scan_rows`` (associative scan) and to
``iir_scan_rows_pallas(interpret=True)`` at atol 1e-5 (the recurrence
contracts, v < 1, so the orders agree to a few f32 ulps), with v up to
0.999, the slowest contraction, at widths in one lane, one chunk, one warp
(512), a block's warps and past one span (4096). Within one lane's run the
run order is the serial recurrence, and within one chunk the pair order is
the plain version's own Hillis-Steele scan, bit for bit.

The dt stage's plain version (``dt_scan_rows_plain``: the maps, then the
row pass with v_h) is held to the JAX mega kernel's own dt stage in
interpret mode (``polyblur_fused._image_call``, ``prefilter='dt'``), read
from its two ``_iir_bidi`` calls per channel on a small canvas: the row
pass's input, map v_h and output, and the column map v_v. Maps atol 1e-6
(chip_smoke's ``TOL_DT``: f32 ``exp`` against the plain version's float64
one, rounded), rows atol 1e-5.

Inputs are seeded numpy draws.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import polyblur_tpu.ops.pallas.polyblur_fused as jfused
import polyblur_tpu.pipeline as jpipe
from polyblur_tpu.ops.domain_transform import iir_scan_rows as jax_scan
from polyblur_tpu.ops.pallas.iir import iir_scan_rows_pallas

from polyblur_torch.ops.cuda.iir import (_affine_scan, dt_coeffs_plain,
                                         dt_scan_rows_plain,
                                         iir_scan_rows_plain)
from polyblur_torch.ops.cuda.polyblur_fused import TileView
from polyblur_torch.pipeline import _mega_pack
from test_torch_iir_taper import _chunked_scan

RUN, LANES, SEG_WARPS = 16, 32, 8
SEG = RUN * LANES
WIDTHS = [1, 31, 33, 447, 448, 512, 513, 1600, 4100]


def _run_pass(a, b):
    """The run order's forward pass over maps laid out (R, spans, warps,
    lanes, run), from a zero start: the values after each element."""
    r, nsp, segs = a.shape[:3]
    # each lane's run, composed serially: (A, B) maps the value before the
    # run to the value at its end
    A = torch.ones(a.shape[:-1])
    B = torch.zeros(a.shape[:-1])
    for j in range(RUN):
        B = a[..., j] * B + b[..., j]
        A = a[..., j] * A
    # the 5-step scan over the lanes (identity shifted in)
    A, B = _affine_scan(A, B, reverse=False)
    out = torch.empty_like(b)
    carry = torch.zeros(r)
    for k in range(nsp):
        # each warp's carry: the span's, through the warps before it
        cw = torch.empty(r, segs)
        run = carry
        for w in range(segs):
            cw[:, w] = run
            run = A[:, k, w, -1] * run + B[:, k, w, -1]
        if segs > 1:
            carry = run
        # each lane's: the value at the end of the lane before it
        e = A[:, k] * cw[..., None] + B[:, k]
        y = torch.cat([cw[..., None], e[..., :-1]], -1)
        for j in range(RUN):
            y = a[:, k, ..., j] * y + b[:, k, ..., j]
            out[:, k, ..., j] = y
    return out


def _pair_pass(a, b):
    """The pair order's forward pass over maps laid out (R, chunks, lane of
    the pair, run), from a zero start: the 5-step scan with the second
    run taking the first's elements, then the chunk walk."""
    r, nch = a.shape[:2]
    for sft in (1, 2, 4, 8, 16):
        sa, sb = torch.ones_like(a), torch.zeros_like(b)
        take = torch.zeros(a.shape, dtype=torch.bool)
        if sft < RUN:   # the run's own elements, then the partner's last
            sa[..., sft:], sb[..., sft:] = a[..., :-sft], b[..., :-sft]
            take[..., sft:] = True
            sa[:, :, 1, :sft] = a[:, :, 0, RUN - sft:]
            sb[:, :, 1, :sft] = b[:, :, 0, RUN - sft:]
            take[:, :, 1, :sft] = True
        else:           # the partner's element at the same position
            sa[:, :, 1], sb[:, :, 1] = a[:, :, 0], b[:, :, 0]
            take[:, :, 1] = True
        b = torch.where(take, a * sb + b, b)
        a = torch.where(take, a * sa, a)
    # each chunk's carry: the previous chunk's last output
    out = torch.empty_like(b)
    carry = torch.zeros(r)
    for c in range(nch):
        out[:, c] = a[:, c] * carry[:, None, None] + b[:, c]
        carry = out[:, c, 1, -1]
    return out


def _schedule(a, b, reverse, pairs):
    """Apply the maps (a, b), (R, W), along the last axis from a zero start
    (from the end when ``reverse``) in one of the kernel's orders."""
    r, w = a.shape
    if pairs:
        shape = (r, -(-w // (2 * RUN)), 2, RUN)
    else:
        segs = 1 if w <= SEG else min(SEG_WARPS, -(-w // SEG))
        shape = (r, -(-w // (segs * SEG)), segs, LANES, RUN)
    pad = int(np.prod(shape[1:])) - w
    a = torch.cat([a, torch.ones(r, pad)], -1).reshape(shape)
    b = torch.cat([b, torch.zeros(r, pad)], -1).reshape(shape)
    dims = tuple(range(1, len(shape)))
    if reverse:   # the same schedule read from the far end
        a, b = a.flip(dims), b.flip(dims)
    out = (_pair_pass if pairs else _run_pass)(a, b)
    if reverse:
        out = out.flip(dims)
    return out.reshape(r, -1)[:, :w]


def _scan(x, v, pairs):
    """The bidirectional IIR along the last axis in one of the kernel's
    orders (iir.py:76-90's recurrence): x, v (..., W) f32."""
    shape = x.shape
    x = x.reshape(-1, shape[-1]).float()
    v = v.reshape(-1, shape[-1]).float()
    col = torch.arange(shape[-1])
    vf = torch.where(col == 0, torch.zeros_like(v), v)
    y = _schedule(vf, (1.0 - vf) * x, False, pairs)
    vs = torch.cat([v[:, 1:], torch.zeros_like(v[:, :1])], -1)
    return _schedule(vs, (1.0 - vs) * y, True, pairs).reshape(shape)


def _run_scan(x, v):
    return _scan(x, v, pairs=False)


def _lane_pair_scan(x, v):
    return _scan(x, v, pairs=True)


def _serial_scan(x, v):
    """The recurrence element by element."""
    x, v = x.float(), v.float()
    w = x.shape[-1]
    y = torch.empty_like(x)
    prev = torch.zeros_like(x[..., 0])
    for i in range(w):
        a = v[..., i] if i else torch.zeros_like(prev)
        prev = a * prev + (1.0 - a) * x[..., i]
        y[..., i] = prev
    z = torch.empty_like(x)
    nxt = torch.zeros_like(prev)
    for i in range(w - 1, -1, -1):
        a = v[..., i + 1] if i < w - 1 else torch.zeros_like(nxt)
        nxt = a * nxt + (1.0 - a) * y[..., i]
        z[..., i] = nxt
    return z


@pytest.mark.parametrize("w", WIDTHS)
@pytest.mark.parametrize("order", ["runs", "pairs"])
def test_row_orders_match_jax_and_pallas(order, w):
    rng = np.random.default_rng(90 + w)
    x = rng.uniform(size=(1, 2, 3, w)).astype(np.float32)
    v = rng.uniform(0.0, 0.999, size=x.shape).astype(np.float32)
    v[..., :40] = 0.999   # the slowest contraction at the rows' start
    xt, vt = torch.as_tensor(x), torch.as_tensor(v)
    got = _scan(xt, vt, pairs=order == "pairs")
    if order == "pairs":
        assert torch.equal(got, _chunked_scan(xt, vt))
    got = got.numpy()
    np.testing.assert_allclose(got, np.asarray(jax_scan(jnp.asarray(x),
                                                        jnp.asarray(v))),
                               atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, np.asarray(iir_scan_rows_pallas(
        jnp.asarray(x), jnp.asarray(v), interpret=True)), atol=1e-5, rtol=0)
    # the port's plain row pass (a full Hillis-Steele scan) agrees too
    plain = iir_scan_rows_plain(xt, vt)
    np.testing.assert_allclose(got, plain.numpy(), atol=1e-5, rtol=0)


@pytest.mark.parametrize("order", ["runs", "pairs"])
def test_one_run_or_chunk_is_exact(order):
    """Within one lane's run (W <= 16) the run order is the serial
    recurrence, bit for bit; within one chunk (W <= 32) the pair order is
    the plain version's own Hillis-Steele scan, bit for bit."""
    rng = np.random.default_rng(91)
    for w in range(1, (RUN if order == "runs" else 2 * RUN) + 1):
        x = torch.as_tensor(rng.uniform(size=(4, w)).astype(np.float32))
        v = torch.as_tensor(rng.uniform(0.0, 0.999, (4, w)).astype(
            np.float32))
        if order == "runs":
            assert torch.equal(_run_scan(x, v), _serial_scan(x, v)), w
        else:
            assert torch.equal(_lane_pair_scan(x, v),
                               iir_scan_rows_plain(x, v)), w


@pytest.mark.parametrize("dt", [np.float32, jnp.bfloat16],
                         ids=["f32", "bf16"])
def test_dt_stage_plain_matches_mega_kernel_interpret(dt):
    """(rows, v_v) of ``dt_scan_rows_plain`` on the tiles of a small canvas
    against what the JAX mega kernel's dt stage hands its ``_iir_bidi``
    calls in interpret mode (one iteration; per channel the row pass with
    v_h, then the column pass of its output with v_v transposed)."""
    rng = np.random.default_rng(92)
    ph, pw, step = 24, 40, (17, 29)
    canvas = rng.uniform(size=(1, 3, ph + step[0], pw + step[1])).astype(
        np.float32)
    jcanvas = jnp.asarray(canvas).astype(dt)
    grid_info = (2, 2) + step + (ph, pw)
    calls = []
    orig = jfused._iir_bidi

    def spy(x, v):
        out = orig(x, v)
        jax.debug.callback(lambda *t: calls.append([np.asarray(a)
                                                    for a in t]), x, v, out)
        return out

    coeffs = jpipe._mega_pack(0.362, 0.468, 6.0, 1.0, 2.0, 0.8)
    jfused._iir_bidi = spy
    try:
        jax.block_until_ready(jfused._image_call(
            jcanvas, coeffs, 1, grid_info, prefilter="dt", interpret=True))
    finally:
        jfused._iir_bidi = orig
    tcanvas = torch.as_tensor(np.array(jcanvas.astype(jnp.float32)))
    if dt is not np.float32:
        tcanvas = tcanvas.to(torch.bfloat16)
    view = TileView(tcanvas, 1, 0, 4, 2, step, (ph, pw))
    tcoeffs = _mega_pack(0.362, 0.468, 6.0, 1.0, 2.0, 0.8)
    rows, v_v = dt_scan_rows_plain(view, tcoeffs)
    v_h = dt_coeffs_plain(view, tcoeffs)[0]
    tiles = view.tiles().float().numpy()
    # the row calls by their input (a tile's channel), the column calls by
    # theirs (the transposed output of a row call)
    by_rows = {}
    for x, v, out in calls:
        if x.shape == (ph, pw):
            hit = [(t, c) for t in range(4) for c in range(3)
                   if np.array_equal(x, tiles[t, c])]
            assert len(hit) == 1
            by_rows[hit[0]] = (v, out)
    assert len(by_rows) == 12
    seen = set()
    for x, v, out in calls:
        if x.shape == (pw, ph):
            (t, c), = [k for k, (_, o) in by_rows.items()
                       if np.array_equal(x, o.T)]
            np.testing.assert_allclose(v.T, v_v[t].numpy(), atol=1e-6,
                                       rtol=0)
            seen.add((t, c))
    assert len(seen) == 12
    for (t, c), (v, out) in by_rows.items():
        np.testing.assert_allclose(v, v_h[t].numpy(), atol=1e-6, rtol=0)
        np.testing.assert_allclose(out, rows[t, c].numpy(), atol=1e-5,
                                   rtol=0)
