#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``openhevc_tpu_torch`` only (nothing of JAX or ``openhevc_tpu``):

1. device: torch / CUDA versions, the card's name and power limit;
2. build: the CUDA kernels (nvcc, sm_90a; K1-K4 and X3) and the native
   C++ front-end;
3. kernels: K1-K4 against their plain PyTorch versions on the card, on
   seeded inputs at small shapes, tolerance 0 (integer pipeline): K1 on
   random quadtrees in valid decode order, plus a forward dependency and
   an overlap that it must reject (raise, not hang); K2 on one pass of
   every tile size and plane, depths 8 and 10; K3 on mixed passes; K4 on
   three-plane frames (one not a multiple of the CTB), depths 8 and 10;
   then the variants of the other formats (``kernels_formats`` lines): K1
   at depths 10-14, on 4:2:2 chroma planes and in 4:4:4 (c444); K2 for
   chroma subsampling (1, 1), (1, 0) and (0, 0) at depths 8-14; K3 on
   4:2:2 and 4:4:4 plane shapes with depth-14 values; K4 at depths 12 and
   14, with 4:2:2 (32x64 chroma tiles) and 4:4:4 (64x64) chroma grids;
   and X3, the SHVC inter-layer upsample kernel, against its gather form
   on whole frames (``kernels_x3`` line): depths 8-14, 4:2:0, 4:2:2 and
   4:4:4, ratios 2x, 1.5x and one that is neither, EL sizes that are no
   multiple of its tile, base rows TMA cannot map (its cp.async path),
   random, all-maximum and alternating samples;
4. decode: the committed 1080p Main clip through ``Decoder(check_md5=True)``
   (the card by default); every decoded-picture-hash SEI must match, every
   kernel must have launched, K1 and K4 once a frame, K2 at most once and
   K3 at most twice;
5. timing: each kernel held again against its plain version, tolerance 0,
   on the clip's own inputs (the I frame's and the first P frame's calls),
   and on those of BQMall 480p, 4K Main, 1080p Main-10, RExt 4:2:2 and
   RExt 4:4:4 (the pipeline phase's other shapes and formats); then timed
   on the clip's (CUDA events) beside its plain version, its bound and,
   where one exists, a single PyTorch call that computes the same
   function: K1 on the I and the P frame with the depth of its wavefront,
   K3 per pass; torch.profiler's device time of every kernel where it has
   one, on the clip's first two frames and on those of Main-10, 4:2:2
   and 4:4:4 (one trace each, split at the I frame's K4);
6. pipeline: the dispatch of one P frame of the clip (plan preparation,
   the one upload, the frame step, the start of the output copy) under
   ``torch.cuda.set_sync_debug_mode("error")``, which raises on any host
   wait; then seven streams (1080p Main 24 frames, BQMall 480p 16, 4K Main
   10, the SHVC stream's 1080p base layer 4, 1080p Main-10 20, RExt 4:2:2
   8 and RExt 4:4:4 8), each decoded twice in full through
   ``PipelinedDecoder()`` with the plain versions refused: every MD5, one
   host-to-device copy a frame, K1 and K4 once a frame, every kernel
   launched; the serial decode's host split beside the pipelined fps; the
   device's idle share in a steady window of the pipelined 1080p decode
   (torch.profiler, which must work);
7. SHVC: both layers of the SHVC stream (1080p base, 4K enhancement, 4
   pictures each) twice through ``ShvcDecoder()``, each layer on its own
   backend on the card and X3, the inter-layer upsample, through its
   kernel with its gather form refused: every MD5 of both layers, every
   kernel launched, X3 once a picture; X3 held against its gather form,
   the NumPy model and the band-matrix form (``upsample_plane_mm``) at
   tolerance 0 on one picture and timed beside all three and its bound,
   its device time also with the base planes out of L2;
8. variants: K4 on per-CTB map grids, K1-K4 on the I, P and B frames of
   the port's variant stream (from both front-ends' plans), that stream
   twice through ``PipelinedDecoder()`` and the encrypted stream twice
   through ``Decoder(encrypt_params=15)``;
9. entry points, the doors users come through, each on the card: the
   clip cut into access units by the port's ``HevcParser`` and fed to
   ``libOpenHevcDecode`` on an ``OpenHevcDecoder()`` with MD5 on, then
   ``GetOutput`` and the EOS drain (every MD5, one upload a frame, the
   fps); both layers of the SHVC stream through the API's layer chain
   (``set_active_decoders(1)``, ``set_view_layers(1)``), X3 on the
   device; ``python -m openhevc_tpu_torch.cli`` on the clip and on the
   clip muxed to MP4, then three times more on the clip with
   ``OPENHEVC_CAP_STORE`` naming one temporary file, each behind a run
   without it (the later store runs start at the first one's caps; each
   run's time to its first frame printed, split into interpreter start,
   import, start-up to the backend, first prepare and the first frame's
   wait); ``tools/abi_driver.c`` linked to the port's C shim
   (``build_abi()``), the backend variable unset.  The CLI's and the
   shim's YUV must be byte-identical to the API's; each subprocess
   reports its launches and uploads a frame on an ``entry_counts`` line
   (a ``sitecustomize`` on its path runs ``report_counts``);
10. mesh, the multi-device paths on the one card (every "device" is
   ``cuda:0``): the clip twice over (two closed-GOP segments) through
   ``MeshDecoder`` on one thread and on two threads at once, each
   segment on its own backend and compute stream (every MD5, the serial
   planes, exact launches K1 48, K2 46, K3 94, K4 48), and once more with
   both segments' first K1 gated to start together, whose grids must be
   in flight at once (CUDA events around every K1 launch); the clip alone
   through ``MeshDecoder`` (one open GOP: ``CudaBackend(device_schedule=
   ...)``); ``dryrun_step`` on ``make_mesh`` of 4 and 8 devices (2 and 4
   CTB-row bands, K4 once a band) on the variant stream and the clip,
   and in the reference's form, which encodes its own 96x96 stream; the
   d5 wire through ``PipelinedDecoder()`` on both (the probe's decision;
   where it is off, d5 forced with the probe's caps and with caps of 8,
   whose overflow falls back to the int32 planes; every d5 wire
   byte-identical to the plain version's); the dispatch of a P frame, a
   B frame and a d5 frame, each behind a sleep queued on the device,
   under torch.profiler: no CUDA call in it that waits for the device,
   and whether it returned before the sleep ended (not when it issues
   more launches than the stream's launch queue holds, which is
   measured); banded K4 against the unbanded plain version and timed;
   the d5 wire timed;
11. the ``kernels`` JSON line (K1-K4 and X3: each kernel's variants and
   its launches on every path), the card line, and the final status line.

Any failure raises and the script exits non-zero without a status line.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
STREAM = os.path.join(ROOT, "streams", "bench_1080p_main_8b78bd6db7.265")
FRAMES = 24
SEED = 2024
K1_REPEATS = 50                # K1 runs held to its plain result per call
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
INT_OPS_PER_S = 67e12          # 32-bit operations outside the tensor cores

T0 = time.time()


def phase(name, t0):
    print(f"phase {name}: {time.time() - t0:.3f} s", flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound(m):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the 32-bit rate."""
    b_bytes = m["bytes"] / HBM_BYTES_PER_S * 1e3
    b_ops = m["ops"] / INT_OPS_PER_S * 1e3
    return dict(bound_ms=max(b_bytes, b_ops),
                bound_by="bytes" if b_bytes >= b_ops else "operations")


def cuda_ms(fn, reps=10, warmup=2):
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions at small shapes
# ---------------------------------------------------------------------------

def k1_blocks(rng, H, W, ctb, min_log2, max_n=None, tall=False):
    """A random quadtree of blocks (2^min_log2 to max_n, default ctb) in
    z-order over the CTBs of an (H, W) plane in raster order, split where
    a block would cross the picture's edge.  tall: CTBs of ctb x 2*ctb, as
    a 4:2:2 chroma plane has them, each its upper square then its lower
    one.  -> [(x, y, n)] in decode order."""
    out = []
    max_n = max_n or ctb

    def split(x, y, n):
        if x >= W or y >= H:
            return
        inside = x + n <= W and y + n <= H
        if n > max_n or (n > 1 << min_log2 and
                         (not inside or rng.random() < 0.55)):
            h = n // 2
            for dy in (0, h):
                for dx in (0, h):
                    split(x + dx, y + dy, h)
        else:
            out.append((x, y, n))
    ch = 2 * ctb if tall else ctb
    for cy in range(0, H, ch):
        for cx in range(0, W, ctb):
            for sy in range(cy, cy + ch, ctb):
                split(cx, sy, ctb)
    return out


def k1_flags(blocks, H, W):
    """The five availability flags of each block, set exactly when every
    unit of that neighbour segment is inside the picture and written by an
    earlier block.  Also returns the segments that are inside the picture
    but written later (a forward dependency if flagged)."""
    order = np.full((H // 4, W // 4), len(blocks), np.int64)
    for b, (x, y, n) in enumerate(blocks):
        order[y // 4:(y + n) // 4, x // 4:(x + n) // 4] = b
    flags, later = [], []
    for b, (x, y, n) in enumerate(blocks):
        segs = ((1, [(y + n + k, x - 1) for k in range(n)]),    # bottom-left
                (2, [(y + k, x - 1) for k in range(n)]),        # left
                (4, [(y - 1, x - 1)]),                          # up-left
                (8, [(y - 1, x + k) for k in range(n)]),        # up
                (16, [(y - 1, x + n + k) for k in range(n)]))   # up-right
        f = fl = 0
        for bit, pts in segs:
            if all(0 <= yy < H and 0 <= xx < W for yy, xx in pts):
                if all(order[yy // 4, xx // 4] < b for yy, xx in pts):
                    f |= bit
                else:
                    fl |= bit
        flags.append(f)
        later.append(fl)
    return flags, later


def k1_meta(rng, blocks, flags):
    """Metadata rows, every mode used, random smoothing requests, padded
    to whole 128-row chunks."""
    from openhevc_tpu_torch.model.intra import INTRA_PRED_ANGLE, INV_ANGLE
    modes = rng.permutation(np.resize(np.arange(35), len(blocks)))
    rows = []
    for (x, y, n), f, mode in zip(blocks, flags, modes):
        mode = int(mode)
        angle = INTRA_PRED_ANGLE[mode - 2] if mode >= 2 else 0
        inv = INV_ANGLE[mode - 11] if 11 <= mode <= 25 else 0
        f |= 32 if rng.random() < 0.6 else 0
        rows.append((x, y, n.bit_length() - 1, mode, angle, inv, f, 1))
    meta = np.zeros((-(-len(rows) // 128) * 128, 8), np.int32)
    meta[:len(rows)] = rows
    return meta


def k1_cases(rng, H=136, W=200, bd=8, cfmt=1):
    """Luma (CTB 32, blocks 4-32) and a chroma plane in valid decode
    order: 4:2:0 (half size, CTB 16, blocks 4-16), 4:2:2 (half width,
    CTBs of 16x32, blocks 4-16) or 4:4:4 (full size, CTB 32, blocks 4-32,
    the c444 kernel), with smooth planes (so the strong filter fires) and
    small residuals at depth bd.  -> [(c_idx, H, W, plane, resid, blocks,
    flags, later)]."""
    cases = []
    chroma = {1: ((H // 2, W // 2), 16, False), 2: ((H, W // 2), 16, True),
              3: ((H, W), 32, False)}[cfmt]
    for c_idx, (h, w), ctb, tall in ((0, (H, W), 32, False),
                                     (1,) + chroma):
        blocks = k1_blocks(rng, h, w, ctb, 2, tall=tall)
        flags, later = k1_flags(blocks, h, w)
        yy, xx = np.mgrid[0:h, 0:w]
        plane = (((60 + yy + xx // 2) << (bd - 8)) +
                 rng.integers(-2, 3, (h, w))).clip(
            0, (1 << bd) - 1).astype(np.int32)
        resid = rng.integers(-3, 4, (h, w)).astype(np.int32)
        resid[rng.random((h, w)) < 0.02] = 90 << (bd - 8)
        cases.append((c_idx, h, w, plane, resid, blocks, flags, later))
    return cases


def _k1_run(dev, cases, metas, strong, poc=None, bd=8, c444=False):
    """K1 on the card against its plain version; K1's error check runs
    for a frame of the given POC and raises on metadata it rejected."""
    import torch
    from openhevc_tpu_torch.torch_backend import intra
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    args = ([t(c[3]) for c in cases], [t(c[4]) for c in cases],
            [t(m.reshape(-1, 128, 8)) for m in metas], [c[0] for c in cases])
    got, errors = intra.intra_planes(*args, bd, strong, c444)
    errors.check(poc)
    ref = [intra.intra_plane_plain(p, r, m, c, bd, strong, c444)
           for p, r, m, c in zip(*args)]
    return max(int((g.long() - r.long()).abs().max())
               for g, r in zip(got, ref))


def check_k1(rng, dev):
    """The wavefront kernel against the sequential plain version on
    metadata in valid decode order, both strong-smoothing settings."""
    from openhevc_tpu_torch.torch_backend import intra
    err = 0
    for strong in (0, 1):
        cases = k1_cases(rng)
        metas = [k1_meta(rng, c[5], c[6]) for c in cases]
        for c, m in zip(cases, metas):
            intra.intra_schedule(m, c[1], c[2], c[0])    # must not raise
        err = max(err, _k1_run(dev, cases, metas, strong))
    return err


# (depth, chroma format) of the small K1 checks beyond check_k1's 8-bit
# 4:2:0: 4:2:2 chroma planes, and 4:4:4 (c444: chroma at luma block
# sizes, with reference smoothing)
K1_FORMATS = ((10, 1), (12, 1), (14, 1), (8, 2), (10, 2), (8, 3), (14, 3))
CFMT = {1: "4:2:0", 2: "4:2:2", 3: "4:4:4"}


def check_k1_formats(rng, dev):
    """The wavefront kernel against the sequential plain version at depths
    10-14, on 4:2:2 chroma planes and in 4:4:4 (K1_FORMATS), strong
    smoothing on."""
    from openhevc_tpu_torch.torch_backend import intra
    err = 0
    for bd, cfmt in K1_FORMATS:
        cases = k1_cases(rng, bd=bd, cfmt=cfmt)
        metas = [k1_meta(rng, c[5], c[6]) for c in cases]
        for c, m in zip(cases, metas):
            intra.intra_schedule(m, c[1], c[2], c[0], cfmt == 3)
        err = max(err, _k1_run(dev, cases, metas, 1, bd=bd,
                               c444=cfmt == 3))
    return err


def check_k1_rejects(rng, dev):
    """Metadata the wavefront cannot schedule must raise, not hang: a flag
    on a neighbour that a later block writes, and two blocks writing one
    unit.  The kernel's raise comes from its error check and names the
    frame's POC; intra_schedule (the plain rule) must reject both too.
    -> 0."""
    from openhevc_tpu_torch.torch_backend import intra
    cases = k1_cases(rng)
    c_idx, H, W, plane, resid, blocks, flags, later = cases[0]
    fwd = list(flags)
    b = next(i for i, fl in enumerate(later) if fl)
    fwd[b] |= later[b]
    over = blocks + [blocks[len(blocks) // 2]]
    for name, meta in (("forward dependency", k1_meta(rng, blocks, fwd)),
                       ("overlap", k1_meta(rng, over, flags + [0]))):
        for rule, run, text in (
                ("intra_schedule",
                 lambda: intra.intra_schedule(meta, H, W, c_idx), ""),
                ("kernel", lambda: _k1_run(dev, cases[:1], [meta], 0, 17),
                 "(frame POC 17)")):
            try:
                run()
            except (RuntimeError, ValueError) as e:
                if text in str(e):
                    continue
                raise AssertionError(f"K1 {rule}: {name} raised without "
                                     f"{text!r}: {e}") from e
            raise AssertionError(f"K1 {rule}: {name} was not rejected")
    return 0


def k2_pass(rng, dev, bd, n=96, H=96, W=128, hs=1, vs=1):
    """One mixed pass: the six tile sizes on a luma plane and two chroma
    planes subsampled by (hs, vs), the chroma groups sharing the luma work
    vectors as frame_step's do; a quarter of the motion vectors point far
    outside the picture.  -> [McGroup]."""
    import torch
    from openhevc_tpu_torch.torch_backend.mc import McGroup
    from openhevc_tpu_torch.torch_backend.plan_compile import TILE_SIZES
    t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)  # noqa
    refs = [t(rng.integers(0, 1 << bd, (3, h, w)))
            for h, w in ((H, W), (H >> vs, W >> hs), (H >> vs, W >> hs))]
    groups = []
    for (w, h) in TILE_SIZES:
        sel = rng.integers(0, 3, n)
        xs = rng.integers(0, W // w, n) * w
        ys = rng.integers(0, H // h, n) * h
        mvx = rng.integers(-64, 65, n)
        mvy = rng.integers(-64, 65, n)
        far = rng.random(n) < 0.25          # motion far outside the picture
        mvx[far] = rng.integers(-4000, 4000, far.sum())
        mvy[far] = rng.integers(-4000, 4000, far.sum())
        vecs = [t(a) for a in (sel, xs, ys, mvx, mvy)]
        for c in range(3):
            sh_, sv_ = (hs, vs) if c else (0, 0)
            groups.append(McGroup(refs[c], *vecs, w >> sh_, h >> sv_,
                                  c == 0, bd, hs, vs, sh_, sv_))
    return groups


def check_k2(rng, dev):
    """One pass of every tile size and plane, depths 8 and 10, against
    mc_pass_plain."""
    from openhevc_tpu_torch.torch_backend import mc as mcm
    err = 0
    for bd in (8, 10):
        groups = k2_pass(rng, dev, bd)
        err = max(err, _max_diff(mcm.mc_pass(groups),
                                 mcm.mc_pass_plain(groups)))
    return err


K2_FORMATS = ((1, 1), (1, 0), (0, 0))        # (hs, vs): 4:2:0, 4:2:2, 4:4:4
DEPTHS = (8, 10, 12, 14)


def check_k2_formats(rng, dev):
    """One pass of every tile size and plane for each chroma subsampling
    (K2_FORMATS) at each depth 8-14, against mc_pass_plain."""
    from openhevc_tpu_torch.torch_backend import mc as mcm
    err = 0
    for hs, vs in K2_FORMATS:
        for bd in DEPTHS:
            groups = k2_pass(rng, dev, bd, n=48, hs=hs, vs=vs)
            err = max(err, _max_diff(mcm.mc_pass(groups),
                                     mcm.mc_pass_plain(groups)))
    return err


def k3_pass(rng, dev, dt, H=200, W=264, n=40, shapes=None, lo=-3000,
            hi=3000):
    """One mixed pass: the six tile shapes on two planes (a luma plane and
    an odd-sized one, or the given shapes), disjoint tiles of values in
    [lo, hi) at random places (some crossing the planes' right and bottom
    edges, some invalid).  -> (groups, planes)."""
    import torch
    shapes = shapes or ((H, W), (H // 2 + 3, W // 2 + 5))
    planes = [torch.as_tensor(rng.integers(-99, 99, s), device=dev).to(dt)
              for s in shapes]
    taken = [np.zeros(p.shape, bool) for p in planes]
    groups = []
    for (h, w) in ((4, 4), (16, 4), (4, 16), (16, 16), (32, 32), (64, 64)):
        for k, plane in enumerate(planes):
            ph, pw = plane.shape
            cells = [(y, x) for y in range(0, ph, h) for x in range(0, pw, w)
                     if not taken[k][y:y + h, x:x + w].any()]
            pick = rng.permutation(len(cells))[:n]
            ys = np.array([cells[i][0] for i in pick], np.int32)
            xs = np.array([cells[i][1] for i in pick], np.int32)
            for y, x in zip(ys, xs):
                taken[k][y:y + h, x:x + w] = True
            valid = (rng.random(len(pick)) > 0.2).astype(np.int32)
            tiles = torch.as_tensor(rng.integers(lo, hi, (len(pick), h, w)),
                                    device=dev).to(dt)
            groups.append((plane, tiles) + tuple(
                torch.as_tensor(a, device=dev) for a in (xs, ys, valid)))
    return groups, planes


def _clone_pass(groups):
    """The groups of a pass on clones of its planes (a plane shared by
    several groups stays shared).  -> (groups, the cloned planes)."""
    clones = {}
    out = [(clones.setdefault(id(g[0]), g[0].clone()),) + tuple(g[1:])
           for g in groups]
    return out, list(clones.values())


def check_k3(rng, dev):
    """A mixed-size pass, int32 then int16, against paint_groups_plain_."""
    import torch
    from openhevc_tpu_torch.torch_backend import paint
    err = 0
    for dt in (torch.int32, torch.int16):
        groups, _ = k3_pass(rng, dev, dt)
        got, gp = _clone_pass(groups)
        ref, rp = _clone_pass(groups)
        paint.paint_groups_(got)
        paint.paint_groups_plain_(ref)
        err = max(err, _max_diff(gp, rp))
    return err


def check_k3_formats(rng, dev):
    """Mixed passes on the plane shapes of 4:2:2 (half-width chroma) and
    4:4:4 (chroma at luma size), int32 and int16, with depth-14 sample
    values, against paint_groups_plain_."""
    import torch
    from openhevc_tpu_torch.torch_backend import paint
    err = 0
    H, W = 136, 200
    for shapes in (((H, W), (H, W // 2)), ((H, W), (H, W))):
        for dt in (torch.int32, torch.int16):
            groups, _ = k3_pass(rng, dev, dt, shapes=shapes, n=24, lo=0,
                                hi=1 << 14)
            got, gp = _clone_pass(groups)
            ref, rp = _clone_pass(groups)
            paint.paint_groups_(got)
            paint.paint_groups_plain_(ref)
            err = max(err, _max_diff(gp, rp))
    return err


def k4_frame(rng, dev, H, W, bd, ctb=64, cfmt=1, ctb_maps=False):
    """A frame of (H, W) luma in chroma format cfmt: three planes, their
    deblocking grids built from random maps over the grids' padded
    geometry (so edges past the picture carry nonzero tc; chroma grids
    with four20 only in 4:2:0), random SAO grids a CTB of each plane
    (csx x csy: 32x32, 32x64 or 64x64 for chroma) and restore masks.
    ctb_maps: the beta/tc offsets come from random per-CTB maps, expanded
    onto the edge grids as frame_step expands a multi-slice picture's."""
    import torch
    from openhevc_tpu_torch.torch_backend import filter as flt
    from openhevc_tpu_torch.torch_backend import frame_step as fs
    t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)  # noqa
    Hp, Wp = H + (-H % 16), W + (-W % 16)
    vbs = t(rng.integers(0, 3, (Hp // 4, Wp // 8)))
    hbs = t(rng.integers(0, 3, (Hp // 8, Wp // 4)))
    qp = t(rng.integers(15, 48, (Hp // 8, Wp // 8)))
    nfm = t(rng.random((Hp // 4, Wp // 4)) < 0.05)
    qpc = t([29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37])
    hs, vs = (1 if cfmt in (1, 2) else 0), (1 if cfmt == 1 else 0)
    bo, to, tcv, tch = 2, -2, 0, 0
    if ctb_maps:
        cm = (-(-H // ctb), -(-W // ctb))
        bmap, tmap = t(rng.integers(-12, 13, cm)), t(rng.integers(-12, 13, cm))
        ix = fs.ctb_map_index(dev, Hp, Wp, ctb.bit_length() - 1, cfmt, *cm)
        bo = (fs._expand(bmap, ix["lv"]), fs._expand(bmap, ix["lh"]))
        to = (fs._expand(tmap, ix["lv"]), fs._expand(tmap, ix["lh_tc"]))
        tcv, tch = fs._expand(tmap, ix["cv"]), fs._expand(tmap, ix["ch"])
    planes, grids, sao, restores = [], [], [], []
    for c in range(3):
        h, w = (H, W) if c == 0 else (H >> vs, W >> hs)
        csx, csy = (ctb, ctb) if c == 0 else (ctb >> hs, ctb >> vs)
        hi = 1 << bd
        base = rng.integers(hi // 4, 3 * hi // 4, (h // 8 + 1, w // 8 + 1))
        base = base.repeat(8, 0).repeat(8, 1)[:h, :w]
        planes.append(t(base + rng.integers(-3, 4, (h, w))))
        if c == 0:
            grids.append(flt.build_luma_grids(vbs, hbs, qp, bo, to, nfm, bd,
                                              Hp, Wp))
        else:
            grids.append(flt.build_chroma_grids(
                vbs, hbs, qp, c, tcv, tch, nfm, qpc, bd, Hp >> vs, Wp >> hs,
                1 << hs, 1 << vs, cfmt == 1))
        grid = (-(-h // csy), -(-w // csx))
        om = rng.integers(-7, 8, grid + (5,))
        om[..., 0] = 0
        sao.append((t(rng.integers(0, 3, grid)), t(rng.integers(0, 32, grid)),
                    t(rng.integers(0, 4, grid)), t(om)))
        restores.append(t(rng.random((h, w)) < 0.02) if c != 1 else None)
    return planes, grids, sao, restores


# (luma H, W, depth, chroma format) of the K4 checks beyond check_k4's
# 4:2:0 at depths 8 and 10: depths 12 and 14, 4:2:2 (chroma CTB tiles of
# 32x64, four20=False) and 4:4:4 (chroma at luma geometry, 64x64)
K4_FORMATS = ((200, 264, 12, 1), (200, 264, 14, 1), (200, 264, 8, 2),
              (384, 512, 12, 2), (200, 264, 8, 3), (200, 264, 14, 3))


def check_k4_formats(rng, dev):
    """Three-plane calls of filter_planes against filter_planes_plain for
    each of K4_FORMATS: deblock and SAO, deblock only, SAO only."""
    from openhevc_tpu_torch.torch_backend import filter as flt
    err = 0
    for (H, W, bd, cfmt) in K4_FORMATS:
        planes, grids, sao, rs = k4_frame(rng, dev, H, W, bd, cfmt=cfmt)
        hs, vs = (1 if cfmt in (1, 2) else 0), (1 if cfmt == 1 else 0)
        for db, so in ((True, True), (True, False), (False, True)):
            args = (planes, grids if db else None, sao if so else None,
                    rs if so else None)
            kw = dict(bd=bd, deblock_on=db, sao_on=so, ctb=64, hs=hs, vs=vs)
            err = max(err, _max_diff(flt.filter_planes(*args, **kw),
                                     flt.filter_planes_plain(*args, **kw)))
    return err


# (luma H, W, depth, chroma format) of the K4 checks with per-CTB map
# grids (multi-slice pictures whose slices carry their own offsets)
K4_MAPS = ((200, 264, 8, 1), (384, 512, 10, 1), (200, 264, 8, 3))


def check_k4_maps(rng, dev):
    """Three-plane calls of filter_planes against filter_planes_plain with
    edge grids built from random per-CTB beta/tc maps, for each of
    K4_MAPS: deblock and SAO, deblock only."""
    from openhevc_tpu_torch.torch_backend import filter as flt
    err = 0
    for (H, W, bd, cfmt) in K4_MAPS:
        planes, grids, sao, rs = k4_frame(rng, dev, H, W, bd, cfmt=cfmt,
                                          ctb_maps=True)
        hs, vs = (1 if cfmt in (1, 2) else 0), (1 if cfmt == 1 else 0)
        for so in (True, False):
            args = (planes, grids, sao if so else None, rs if so else None)
            kw = dict(bd=bd, deblock_on=True, sao_on=so, ctb=64, hs=hs,
                      vs=vs)
            err = max(err, _max_diff(flt.filter_planes(*args, **kw),
                                     flt.filter_planes_plain(*args, **kw)))
    return err


# what the small-shape checks hold on the card, a kernel at a time
SMALL_VARIANTS = {
    "intra": ["4:2:0 depth 8 (both strong settings, and two rejections)"] + [
        f"{CFMT[c]} depth {bd}" + (" (c444)" if c == 3 else "")
        for bd, c in K1_FORMATS],
    "mc": [f"(hs, vs)=({hs}, {vs}) depths 8-14" for hs, vs in K2_FORMATS],
    "paint": ["4:2:0-like planes int32/int16",
              "4:2:2 and 4:4:4 plane shapes int32/int16, depth-14 values"],
    "filter": ["4:2:0 depths 8 and 10"] + [
        f"{CFMT[c]} depth {bd} {H}x{W}" for H, W, bd, c in K4_FORMATS],
}


def check_k4(rng, dev):
    """Three-plane calls of filter_planes against filter_planes_plain: a
    frame whose sizes are multiples of the CTB, one whose sizes are not
    (200x264 luma, CTB 64), deblock-only, SAO-only, restore masks, bit
    depths 8 and 10; and the one-plane entry filter_plane."""
    from openhevc_tpu_torch.torch_backend import filter as flt
    err = 0
    for (H, W, bd) in ((384, 512, 8), (200, 264, 8), (200, 264, 10)):
        planes, grids, sao, rs = k4_frame(rng, dev, H, W, bd)
        for db, so in ((True, True), (True, False), (False, True)):
            args = (planes, grids if db else None, sao if so else None,
                    rs if so else None)
            kw = dict(bd=bd, deblock_on=db, sao_on=so, ctb=64, hs=1, vs=1)
            err = max(err, _max_diff(flt.filter_planes(*args, **kw),
                                     flt.filter_planes_plain(*args, **kw)))
        kw = dict(luma=True, bd=bd, deblock_on=True, sao_on=True, csx=64,
                  csy=64)
        err = max(err, _max_diff(
            [flt.filter_plane(planes[0], *grids[0], sao[0], rs[0], **kw)],
            [flt.filter_plane_plain(planes[0], *grids[0], sao[0], rs[0],
                                    **kw)]))
    return err


# X3, the SHVC inter-layer upsample: (base-layer luma W, H) -> (EL W, H);
# no EL size is a multiple of the kernel's 64x64 tile; the last case's base
# rows are no multiple of 16 bytes, so TMA cannot map them (the kernel's
# cp.async path) and its EL rows start off 16-byte alignment
X3_RATIOS = (("2x", (136, 72), (272, 144)), ("1.5x", (184, 104), (276, 156)),
             ("arbitrary", (200, 120), (344, 216)),
             ("1.5x unaligned", (90, 50), (135, 75)))
X3_DEPTHS = (8, 10, 12, 14)
X3_INPUTS = ("random", "max", "alternating 0/max")


def x3_source(rng, kind, bd, shape):
    mx = (1 << bd) - 1
    if kind == "max":
        return np.full(shape, mx, np.int32)
    if kind == "alternating 0/max":
        yy, xx = np.indices(shape)
        return (((yy + xx) & 1) * mx).astype(np.int32)
    return rng.integers(0, mx + 1, shape).astype(np.int32)


def x3_plain_frame(up, bl_planes, w_el, h_el, bit_depth=8,
                   chroma_format_idc=1):
    """X3's plain version (the gather form, ``upsample_plane``) on the
    same tables as the kernel's, from CudaUpsampler ``up``."""
    from openhevc_tpu_torch.torch_backend import upsample as x3
    return [x3.upsample_plane(p, *plan[:4], bit_depth=bit_depth)
            for p, plan in up.frame_plans(bl_planes, w_el, h_el,
                                          chroma_format_idc)]


def check_fp32_matmul():
    """upsample_plane_mm needs float32 products in full float32: raise
    when TF32 matmul is allowed or the float32 matmul precision is not
    "highest" (both are PyTorch's defaults; nothing here sets either)."""
    import torch
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != "highest":
        raise RuntimeError("upsample_plane_mm needs full float32 matmul: "
                           "allow_tf32 False and precision 'highest'")


def upsample_plane_mm(src, mx, my, bit_depth=8):
    """X3's library yardstick, on no decode path: src (H_BL, W_BL) int32,
    mx (W_BL, W_EL) and my (H_EL, H_BL) float32 band matrices
    (``band_matrix``; my transposed) -> (H_EL, W_EL) int32, the
    reference's ``upsample_plane_mxu`` as two float32 ``torch.mm``
    products.

    Exact at every depth to 14 without the reference's hi/lo split: every
    partial sum is an integer below 2^24, float32's integer-exact range
    (the horizontal sums below 112 * 2^14, the vertical ones, over the
    int16-wrapped intermediate, below 112 * 2^15), whatever the order of
    the sums.  That needs float32 products in full float32:
    ``torch.backends.cuda.matmul.allow_tf32`` False and
    ``torch.get_float32_matmul_precision()`` "highest", PyTorch's
    defaults; it raises otherwise and changes neither."""
    import torch
    from openhevc_tpu_torch.torch_backend.upsample import I_OFFSET, N_SHIFT
    check_fp32_matmul()
    t = torch.mm(src.to(torch.float32), mx).to(torch.int32)
    t = ((t + 0x8000) & 0xFFFF) - 0x8000
    acc = torch.mm(my, t.to(torch.float32)).to(torch.int32)
    return torch.clamp((acc + I_OFFSET) >> N_SHIFT, 0, (1 << bit_depth) - 1)


def check_x3(rng, dev):
    """X3's kernel (CudaUpsampler) against its plain version
    (``x3_plain_frame``) on the same card tensors and tables, whole
    frames: depths 8-14, 4:2:0, 4:2:2 and 4:4:4, ratios 2x, 1.5x and one
    that is neither, random, all-maximum and alternating 0/maximum
    samples (the last two drive the int16 wrap of the intermediate above
    depth 8)."""
    import torch
    from openhevc_tpu_torch.torch_backend.upsample import CudaUpsampler
    up = CudaUpsampler()
    err = 0
    for _name, (w_bl, h_bl), (w_el, h_el) in X3_RATIOS:
        for cfmt in (1, 2, 3):
            hs, vs = (1 if cfmt in (1, 2) else 0), (1 if cfmt == 1 else 0)
            shapes = [(h_bl, w_bl)] + [(h_bl >> vs, w_bl >> hs)] * 2
            for bd in X3_DEPTHS:
                for kind in X3_INPUTS:
                    bl = [torch.as_tensor(x3_source(rng, kind, bd, s),
                                          device=dev) for s in shapes]
                    kw = dict(bit_depth=bd, chroma_format_idc=cfmt)
                    got = up.upsample_frame(bl, w_el, h_el, **kw)
                    want = x3_plain_frame(up, bl, w_el, h_el, **kw)
                    err = max(err, _max_diff(got, want))
    return err


X3_VARIANTS = [f"{CFMT[c]} depths 8-14 at {r} ({bl[0]}x{bl[1]} to "
               f"{el[0]}x{el[1]}), {', '.join(X3_INPUTS)} samples"
               for r, bl, el in X3_RATIOS for c in (1, 2, 3)]


# ---------------------------------------------------------------------------
# phases 4-5: the clip, and the kernels timed on its inputs
# ---------------------------------------------------------------------------

def decode_clip(data, n_frames, split=None, use_native=True):
    """Decode the first n_frames pictures; returns (frames, decoder).

    split: optional dict that receives host seconds spent in the backend's
    plan preparation, in enqueueing the frame's device work, and in the
    output fetch + MD5 check (which waits for the device); the rest of
    the wall time is the front-end's parse.  use_native=False takes the
    plans from the Python front-end."""
    from openhevc_tpu_torch.decoder.frontend import Decoder
    dec = Decoder(check_md5=True, use_native=use_native)
    backend = dec.backend
    if split is not None:
        for obj, name, key in ((backend, "prepare_host", "prepare_s"),
                               (backend, "decode_prepared", "enqueue_s"),
                               (dec, "_verify_md5", "fetch_md5_s")):
            split[key] = 0.0
            setattr(obj, name, _timed(getattr(obj, name), split, key))
    frames = dec.decode_stream(_first_pictures(data, n_frames))
    for f in frames:
        f.host_planes()                 # the output fetch (synchronizes)
    return frames, dec


def decode_checked(data, n_frames, split=None, use_native=True):
    """decode_clip, raising unless n_frames pictures came out with all
    three plane MD5s of each matching the stream's SEI."""
    frames, dec = decode_clip(data, n_frames, split, use_native)
    if (len(frames) != n_frames or dec.md5_ok != 3 * n_frames
            or dec.md5_fail):
        raise AssertionError(
            f"decode of {n_frames} frames: {len(frames)} frames, md5_ok="
            f"{dec.md5_ok} md5_fail={dec.md5_fail}")
    return frames, dec


def _timed(fn, acc, key):
    def run(*a, **kw):
        t = time.perf_counter()
        out = fn(*a, **kw)
        acc[key] += time.perf_counter() - t
        return out
    return run


def _first_pictures(data, n):
    """The stream cut after its n-th picture (parameter sets, slices and
    their SEI NALs kept)."""
    if n is None:
        return data
    from openhevc_tpu_torch.bitstream import nal as nalmod
    starts = []
    i = 0
    while True:
        j = data.find(b"\x00\x00\x01", i)
        if j < 0:
            break
        starts.append(j - 1 if j > 0 and data[j - 1] == 0 else j)
        i = j + 3
    pics = 0
    for k, s in enumerate(starts):
        hdr = data[data.find(b"\x00\x00\x01", s) + 3]
        typ = (hdr >> 1) & 63
        if nalmod.is_vcl(typ):
            first = data[data.find(b"\x00\x00\x01", s) + 5] >> 7
            if first:
                pics += 1
                if pics > n:
                    return data[:s]
    return data


class Recorder:
    """Records the arguments of each kernel wrapper that frame_step calls
    (for timing the kernels on the clip's own inputs)."""

    def __init__(self):
        from openhevc_tpu_torch.torch_backend import frame_step as fs
        self.fs = fs
        self.calls = {k: [] for k in ("intra", "mc", "paint", "filter")}
        self.names = {"intra": "intra_planes", "mc": "mc_pass",
                      "paint": "paint_groups_", "filter": "filter_planes"}
        self.orig = {k: getattr(fs, n) for k, n in self.names.items()}

    def __enter__(self):
        def wrap(kind, fn):
            def rec(*a, **kw):
                args = list(a)
                if kind == "paint":     # painted in place: keep the input
                    args[0] = _clone_pass(a[0])[0]
                self.calls[kind].append((args, dict(kw)))
                return fn(*a, **kw)
            return rec
        for k, n in self.names.items():
            setattr(self.fs, n, wrap(k, self.orig[k]))
        return self

    def __exit__(self, *exc):
        for k, n in self.names.items():
            setattr(self.fs, n, self.orig[k])


def _max_diff(got, ref):
    """Largest difference over lists of tensors; 0 for empty lists (an I
    frame's MC pass has no groups)."""
    if len(got) != len(ref) or any(g.shape != r.shape
                                   for g, r in zip(got, ref)):
        raise AssertionError("kernel and plain version differ in shape")
    return max((int((g.long() - r.long()).abs().max()) if g.numel() else 0
                for g, r in zip(got, ref)), default=0)


def check_clip_calls(calls):
    """Each kernel against its plain version on the clip's recorded calls,
    at the main path's shapes (full 1080p planes, the partial last CTB row,
    the real MC batches).  K1's schedule changes from run to run (a stale
    read would show as a difference that comes and goes), so it is held
    to the plain result K1_REPEATS times.  -> {kernel: max abs
    difference}."""
    from openhevc_tpu_torch.torch_backend import (filter as flt, intra,
                                                  mc as mcm, paint)
    errs = {k: 0 for k in calls}
    for (a, kw) in calls["intra"]:
        planes, resids, metas, cidx, bd, strong, c444 = a
        ref = [intra.intra_plane_plain(p, r, m, c, bd, strong, c444)
               for p, r, m, c in zip(planes, resids, metas, cidx)]
        for _ in range(K1_REPEATS):
            got, errors = intra.intra_planes(*a, **kw)
            errors.check()
            errs["intra"] = max(errs["intra"], _max_diff(got, ref))
    for (a, kw) in calls["mc"]:
        errs["mc"] = max(errs["mc"], _max_diff(mcm.mc_pass(*a, **kw),
                                               mcm.mc_pass_plain(*a, **kw)))
    for (a, kw) in calls["paint"]:
        got, gp = _clone_pass(a[0])
        ref, rp = _clone_pass(a[0])
        paint.paint_groups_(got)
        paint.paint_groups_plain_(ref)
        errs["paint"] = max(errs["paint"], _max_diff(gp, rp))
    for (a, kw) in calls["filter"]:
        errs["filter"] = max(errs["filter"], _max_diff(
            flt.filter_planes(*a, **kw), flt.filter_planes_plain(*a, **kw)))
    return errs


def _k1_numbers(call, plain_reps):
    """K1 timed on one recorded call, with its size and the depth of its
    wavefront per plane (intra_schedule)."""
    from openhevc_tpu_torch.torch_backend import intra
    a, kw = call
    planes, resids, metas, cidx, bd, strong, c444 = a
    mnp = [m.cpu().numpy().reshape(-1, 8) for m in metas]
    valid = [m[:, 7] != 0 for m in mnp]
    # intra samples: each valid block at the size the kernel gives it,
    # clipped to its plane
    samples = 0
    for m, v, p, c in zip(mnp, valid, planes, cidx):
        H, W = p.shape
        b = m[v].astype(np.int64)
        n = 1 << np.clip(b[:, 2], 2, 5 if (c == 0 or c444) else 4)
        samples += int((np.clip(H - b[:, 1], 0, n) *
                        np.clip(W - b[:, 0], 0, n)).sum())
    depth = [int(intra.intra_schedule(m, p.shape[0], p.shape[1], c,
                                      c444).max()) + 1
             for m, p, c in zip(mnp, planes, cidx)]
    return dict(
        ms=cuda_ms(lambda: intra.intra_planes(*a)),
        plain_ms=cuda_ms(lambda: [intra.intra_plane_plain(
            p, r, m, c, bd, strong, c444) for p, r, m, c in
            zip(planes, resids, metas, cidx)], reps=plain_reps, warmup=0),
        # the function returns new planes: each plane read and its copy
        # written once; the residual read at intra samples; the metadata
        bytes=sum(p.numel() * 4 * 2 + m.numel() * 4
                  for p, m in zip(planes, metas)) + 4 * samples,
        ops=12 * samples, library_ms=None,
        blocks=[int(v.sum()) for v in valid], depth=depth)


def _k3_numbers(groups):
    """K3 timed on one recorded pass, beside one index_put_ that writes
    the same samples into a flat buffer of the pass's planes (indices and
    values made outside the timed window)."""
    import torch
    from openhevc_tpu_torch.torch_backend import paint
    groups, planes = _clone_pass(groups)
    off, base = {}, 0
    for p in planes:
        off[id(p)] = base
        base += p.numel()
    flat = torch.cat([p.reshape(-1) for p in planes])
    byts, idx, vals = 0, [], []
    for (plane, tiles, xs, ys, valid) in groups:
        n, h, w = tiles.shape
        H, W = plane.shape
        gy = ys.long()[:, None, None] + torch.arange(h, device=plane.device)[
            None, :, None]
        gx = xs.long()[:, None, None] + torch.arange(w, device=plane.device)[
            None, None, :]
        m = ((valid != 0)[:, None, None] & (gy >= 0) & (gy < H) &
             (gx >= 0) & (gx < W))
        # a tile sample read and written where it lands in the plane;
        # xs, ys and valid read
        byts += 2 * int(m.sum()) * tiles.element_size() + 3 * n * 4
        idx.append((off[id(plane)] + gy * W + gx)[m])
        vals.append(tiles[m])
    idx, vals = torch.cat(idx), torch.cat(vals)
    return dict(
        ms=cuda_ms(lambda: paint.paint_groups_(groups)),
        plain_ms=cuda_ms(lambda: paint.paint_groups_plain_(groups), reps=3),
        library_ms=cuda_ms(lambda: flat.index_put_((idx,), vals)),
        bytes=byts, groups=len(groups), dtype=str(flat.dtype))


def time_kernels(data):
    """Per kernel, the work of one frame of the clip: K1 on the I frame and
    on the first P frame, K2/K3/K4 on the first P frame (K3 per pass).
    Before timing, every kernel is held against its plain version on the
    recorded calls of both frames.
    -> ({kernel: dict of numbers}, {kernel: max abs difference})."""
    import torch
    from openhevc_tpu_torch.torch_backend import (filter as flt, mc as mcm)
    with Recorder() as rec_i:
        decode_checked(data, 1)
    with Recorder() as rec_p:
        decode_checked(data, 2)
    errs = check_clip_calls(rec_p.calls)
    torch.cuda.synchronize()
    # the P frame's calls follow the I frame's in the second recording
    n_i = {k: len(v) for k, v in rec_i.calls.items()}
    p_calls = {k: v[n_i[k]:] for k, v in rec_p.calls.items()}
    out = {}

    # K1: one call (three planes) on the I frame, and on the P frame
    (call_i,) = rec_i.calls["intra"]
    (call_p,) = p_calls["intra"]
    out["intra"] = _k1_numbers(call_i, 1)
    out["intra"]["p_frame"] = _k1_numbers(call_p, 3)

    # K3: the P frame's two passes (MC predictions, residual canvas)
    passes = [_k3_numbers(a[0]) for (a, kw) in p_calls["paint"]]
    out["paint"] = dict(
        {k: sum(p[k] for p in passes) for k in ("ms", "plain_ms",
                                                "library_ms", "bytes")},
        ops=0, passes=passes)

    # K2: the P frame's pass (every tile size and plane)
    (call,) = p_calls["mc"]
    groups = call[0][0]
    byts = ops = 0
    for g in groups:
        taps = 8 if g.is_luma else 4
        n = g.xs.numel()
        win = n * (g.h + taps - 1) * (g.w + taps - 1) * 4
        byts += min(win, g.refs.numel() * 4) + 5 * n * 4 + n * g.h * g.w * 4
        ops += n * 2 * taps * ((g.h + taps - 1) * g.w + g.h * g.w)
    out["mc"] = dict(
        ms=cuda_ms(lambda: mcm.mc_pass(groups)),
        plain_ms=cuda_ms(lambda: mcm.mc_pass_plain(groups), reps=3),
        bytes=byts, ops=ops, library_ms=None, groups=len(groups))

    # K4: the P frame's call (three planes)
    (call,) = p_calls["filter"]
    a, kw = call
    planes, grids, sao, restores = a
    byts = 0
    for c, plane in enumerate(planes):
        byts += 2 * plane.numel() * 4
        tensors = list(grids[c][0]) + list(grids[c][1]) if grids else []
        tensors += list(sao[c]) if sao else []
        if restores and restores[c] is not None:
            tensors.append(restores[c])
        byts += sum(g.numel() * 4 for g in tensors)
    samples = sum(p.numel() for p in planes)
    out["filter"] = dict(
        ms=cuda_ms(lambda: flt.filter_planes(*a, **kw)),
        plain_ms=cuda_ms(lambda: flt.filter_planes_plain(*a, **kw), reps=3),
        bytes=byts, ops=30 * samples, library_ms=None)
    torch.cuda.synchronize()
    return out, errs


# the other bench streams' shapes and formats, which the main path meets
# only in the pipeline phase: 832x480 (chroma rows 416 samples wide, a new
# K4 tensor-map pitch), 3840x2160 (K1's largest wavefront, K2's and K4's
# largest grids), Main-10 1080p (every kernel at depth 10), 4:2:2 (K1 on
# stacked chroma blocks, K2's (1, 0) phases, K4's 32x64 chroma tiles) and
# 4:4:4 (c444, K2's (0, 0) phases, 64x64 chroma tiles).  The SHVC base
# layer is 1920x1080, the clip's own shape.
CLIP_CHECK_STREAMS = ("bqmall_480p", "4k_main", "1080p_main10", "rext_422",
                      "rext_444")
# streams whose first frames' kernel device times are profiled besides
# the clip's
PROFILE_STREAMS = ("1080p_main10", "rext_422", "rext_444")


def check_stream_calls(name, data=None, n_frames=2, use_native=True):
    """check_clip_calls on the recorded calls of a stream's first
    n_frames pictures (a bench stream's I frame and first P frame by
    default), decoded through the kernels with MD5s checked, the plans
    from the native front-end or (use_native=False) the Python one.
    -> {kernel: max abs difference}."""
    with Recorder() as rec:
        decode_checked(bench_stream(name) if data is None else data,
                       n_frames, use_native=use_native)
    if not all(rec.calls[k] for k in ("intra", "mc", "paint", "filter")):
        raise AssertionError(f"{name}: a kernel was not called on its "
                             f"first {n_frames} frames")
    return check_clip_calls(rec.calls)


def profile_frames(data):
    """Device time of K1-K4 from torch.profiler over one decode of the I
    frame and the first P frame (checked like the main path's): each
    kernel's device intervals in the trace, the I frame's being those that
    end by the end of the first K4 kernel (a frame's last; every kernel
    runs on one stream), the P frame's the rest.  A profiler that fails,
    or a trace without both frames' K4, fails the phase.  -> {kernel:
    {"i_frame": ms, "p_frame": ms}}, a value None where the frame ran no
    such kernel (an I frame runs no K2)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    names = {"intra": ("owner_kernel", "wavefront_kernel"),
             "mc": ("mc_pass_kernel",),
             "paint": ("paint_pass_kernel",),
             "filter": ("filter_frame_kernel",)}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        decode_checked(data, 2)
        torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end, k)
             for e in prof.events()
             if str(getattr(e, "device_type", "")).endswith("CUDA")
             for k, pats in names.items() if any(p in e.name for p in pats)]
    ends = sorted(e for _s, e, k in spans if k == "filter")
    if len(ends) != 2:
        raise AssertionError(f"profile: {len(ends)} K4 kernels in the "
                             f"trace of two frames")
    t = {k: [0.0, 0.0] for k in names}
    for s_, e, k in spans:
        t[k][0 if e <= ends[0] else 1] += (e - s_) / 1e3
    return {k: {"i_frame": v[0] or None, "p_frame": v[1] or None}
            for k, v in t.items()}


# ---------------------------------------------------------------------------
# phase 6: the pipelined decoder on the four 8-bit 4:2:0 bench streams
# ---------------------------------------------------------------------------

def _shapes(h, w, cfmt=1):
    hs, vs = (1 if cfmt in (1, 2) else 0), (1 if cfmt == 1 else 0)
    return [(h, w), (h >> vs, w >> hs), (h >> vs, w >> hs)]


# (name, frames, plane shapes): every frame of each stream, the SHVC
# stream's base layer only
PIPELINE_STREAMS = (("1080p_main", 24, _shapes(1080, 1920)),
                    ("bqmall_480p", 16, _shapes(480, 832)),
                    ("4k_main", 10, _shapes(2160, 3840)),
                    ("shvc_4k60", 4, _shapes(1080, 1920)),
                    ("1080p_main10", 20, _shapes(1080, 1920)),
                    ("rext_422", 8, _shapes(480, 832, 2)),
                    ("rext_444", 8, _shapes(480, 832, 3)))
PIPELINE_RUNS = 2              # each stream decoded twice
# streams whose first P frame's dispatch runs under sync debug "error": the
# 8-bit wire, the packed 10-bit wire, 4:4:4 shapes
SYNC_STREAMS = ("1080p_main", "1080p_main10", "rext_444")
PR6_SPLIT = {"prepare_s": 0.485, "enqueue_s": 1.006}   # PERF.md section 5


def bench_stream(name):
    (path,) = [os.path.join(ROOT, "streams", f)
               for f in os.listdir(os.path.join(ROOT, "streams"))
               if f.startswith(f"bench_{name}_") and f.endswith(".265")]
    with open(path, "rb") as f:
        return f.read()


def decode_pipelined(data, n_frames, shapes):
    """The whole stream through PipelinedDecoder() (the card by default),
    every frame fetched to the host; raises unless n_frames frames of the
    expected shape came out with every plane's MD5 matching.  -> (wall
    seconds, launches per kernel, H2D copies, the decoder, the busy
    seconds of the parser thread and of the dispatcher's frame dispatch
    without its MD5 check).  The counters are set to 0 once the decoder
    is built; the constant tables, cached per device, went up in an
    earlier phase."""
    import torch
    from openhevc_tpu_torch.runtime import PipelinedDecoder
    from openhevc_tpu_torch.torch_backend import device
    from openhevc_tpu_torch.decoder.frontend import Frontend
    dec = PipelinedDecoder(check_md5=True)
    torch.cuda.synchronize()
    device.reset_launches()
    # the parser thread's busy time: every Frontend call it makes
    busy = {"parse_s": 0.0}
    saved = [(n, getattr(Frontend, n)) for n in ("decode_nal", "end_picture")]
    for n, fn in saved:
        setattr(Frontend, n, _timed(fn, busy, "parse_s"))
    t = time.time()
    frames = []
    try:
        for f in dec.frames(data):
            f.host_planes()
            frames.append(f)
        torch.cuda.synchronize()
    finally:
        for n, fn in saved:
            setattr(Frontend, n, fn)
    wall = time.time() - t
    busy["dispatch_s"] = dec.stats.decode_time_s
    if (len(frames) != n_frames or dec.md5_ok != 3 * n_frames
            or dec.md5_fail):
        raise AssertionError(
            f"pipelined decode: {len(frames)} frames of {n_frames}, md5_ok="
            f"{dec.md5_ok} md5_fail={dec.md5_fail}")
    for f in frames:
        if [tuple(p.shape) for p in f.host_planes()] != shapes:
            raise AssertionError("pipelined decode: unexpected plane shapes")
    return wall, device.launches(), device.h2d_copies(), dec, busy


def check_no_sync(data, slice_type=1):
    """The dispatch of a stream's first P frame (slice_type 1; 0: its
    first B frame) among its first three pictures (prepare_host, the
    upload, frame_step and copy_to_host_async: Decoder._reconstruct) on
    the backend's compute stream, under
    torch.cuda.set_sync_debug_mode("error"): any call that waits for the
    device raises.  The frames around it decode normally, MD5s checked.
    -> the POC checked."""
    import torch
    from openhevc_tpu_torch.decoder.frontend import Decoder
    dec = Decoder(check_md5=True)
    inner = dec._reconstruct
    checked = []

    def guarded(plan):
        if plan.slice_type != slice_type or checked:
            return inner(plan)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            frame = inner(plan)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        checked.append(plan.poc)
        return frame
    dec._reconstruct = guarded
    with torch.cuda.stream(dec.backend.compute_stream):
        frames = dec.decode_stream(_first_pictures(data, 3))
        for f in frames:
            f.host_planes()
    torch.cuda.synchronize()
    if len(checked) != 1 or dec.md5_ok != 9 or dec.md5_fail:
        raise AssertionError(f"sync check: P frames {checked}, md5_ok="
                             f"{dec.md5_ok}")
    return checked[0]


def idle_share(data, skip=4):
    """The device's idle share in a steady window of the pipelined 1080p
    decode: torch.profiler runs from the (skip+1)-th frame handed out to
    the last; the window spans the first to the last device activity it
    recorded (kernels, copies, fills), and idle is the part of it that no
    device activity covers.  The decode is checked like the main path's;
    a profiler that fails, or a trace without device activity, fails the
    phase.  -> dict of numbers."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from openhevc_tpu_torch.runtime import PipelinedDecoder
    dec = PipelinedDecoder(check_md5=True)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    n = 0
    for f in dec.frames(data):
        f.host_planes()
        n += 1
        if n == skip:
            prof.start()
    torch.cuda.synchronize()
    prof.stop()
    if n != FRAMES or dec.md5_ok != 3 * FRAMES or dec.md5_fail:
        raise AssertionError(f"profiled pipelined decode: {n} frames, "
                             f"md5_ok={dec.md5_ok}")
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events()
                   if str(getattr(e, "device_type", "")).endswith("CUDA"))
    if not spans:
        raise AssertionError("idle share: no device activity in the trace")
    busy, (cur_s, cur_e) = 0.0, spans[0]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    window = spans[-1][1] - spans[0][0]
    return dict(frames=FRAMES - skip, window_ms=window / 1e3,
                busy_ms=busy / 1e3, idle_share=1 - busy / window)


# ---------------------------------------------------------------------------
# phase 7: two-layer SHVC on the card, and X3, its inter-layer upsample
# ---------------------------------------------------------------------------

SHVC_RUNS = 2
SHVC_PICTURES = 4              # a layer
SHVC_EL = _shapes(2160, 3840)


def decode_shvc(data):
    """Both layers of the SHVC bench stream through the port's
    ShvcDecoder() (each layer on its own CudaBackend on the card, X3 on
    the device), every EL frame fetched to the host; raises unless both
    layers gave SHVC_PICTURES frames of the expected shapes with every
    plane's MD5 matching and every inter-layer reference was upsampled on
    the card by X3's kernel, one launch a picture.  -> (wall seconds,
    launches per kernel, X3 calls, X3 launches, H2D copies, the decoder,
    the layers' outputs).  The counters are set to 0 once the decoder is
    built."""
    import torch
    from openhevc_tpu_torch.decoder.shvc import ShvcDecoder
    from openhevc_tpu_torch.torch_backend import device
    from openhevc_tpu_torch.torch_backend.upsample import CudaUpsampler
    dec = ShvcDecoder(check_md5=True)
    torch.cuda.synchronize()
    device.reset_launches()
    where, calls = set(), []
    inner = CudaUpsampler.upsample_frame

    def seen(self, planes, *a, **kw):
        out = inner(self, planes, *a, **kw)
        where.update(p.device.type for p in list(planes) + out)
        calls.append(1)
        return out
    CudaUpsampler.upsample_frame = seen
    t = time.time()
    try:
        outs = dec.decode_stream(data)
        for f in outs[1]:
            f.host_planes()
        torch.cuda.synchronize()
    finally:
        CudaUpsampler.upsample_frame = inner
    wall = time.time() - t
    n = SHVC_PICTURES
    if ([len(o) for o in outs] != [n, n] or dec.md5_ok != 6 * n
            or dec.md5_fail):
        raise AssertionError(
            f"SHVC decode: {[len(o) for o in outs]} frames, md5_ok="
            f"{dec.md5_ok} md5_fail={dec.md5_fail}")
    for lid, want in ((0, _shapes(1080, 1920)), (1, SHVC_EL)):
        for f in outs[lid]:
            if [tuple(p.shape) for p in f.host_planes()] != want:
                raise AssertionError(f"SHVC layer {lid}: unexpected shapes")
    x3n = device.x3_launches()
    if not calls or where != {"cuda"} or x3n != len(calls):
        raise AssertionError(f"SHVC: {len(calls)} inter-layer upsamples, "
                             f"on {sorted(where)}, {x3n} X3 launches")
    return (wall, device.launches(), len(calls), x3n, device.h2d_copies(),
            dec, outs)


def x3_device_ms(fn, reps=20, before=None):
    """Device time of X3's kernel for one picture (torch.profiler): fn
    (one picture, one launch for its three planes) once to warm up, then
    reps times under the profiler, each behind ``before`` when given; the
    mean of the kernel's spans.  A trace may miss kernels at its start (3
    of 5 once, in the middle of this script), so it needs half of the
    launches; fewer, or a profiler that fails, fails the phase."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            if before is not None:
                before()
            fn()
        torch.cuda.synchronize()
    spans = [e.time_range.end - e.time_range.start for e in prof.events()
             if str(getattr(e, "device_type", "")).endswith("CUDA")
             and "upsample_frame_kernel" in e.name]
    if len(spans) < reps // 2:
        raise AssertionError(f"X3 profile: {len(spans)} kernels in the "
                             f"trace of {reps} pictures")
    return np.mean(spans) / 1e3


L2_FLUSH_BYTES = 128 << 20     # read before a cold picture: > the 50 MB L2


def time_x3(bl_planes):
    """X3 on one picture of the SHVC stream (1920x1080 base layer to the
    3840x2160 enhancement layer, 4:2:0, depth 8): the kernel held against
    its plain version (the gather form), the NumPy model (model/upsample.py,
    the reference's arithmetic) and the band-matrix form
    (upsample_plane_mm, the library yardstick), tolerance 0; then each
    timed by CUDA events, and the kernel's device time by torch.profiler,
    back to back (the base planes, 12.4 MB, fit the 50 MB L2, but each
    picture's 49.8 MB of writes pass through it) and cold (a 128 MB read
    before each picture: the base planes come from device memory).  Its
    bound is the larger of the bytes it must move (the int32 base planes
    read once, the EL planes written once) and its operations (a multiply
    and an add a tap, both passes)."""
    import torch
    from openhevc_tpu_torch.model.upsample import UpsampleInfo, upsample_frame
    from openhevc_tpu_torch.torch_backend import upsample as x3
    kern = x3.CudaUpsampler()
    h_el, w_el = SHVC_EL[0]
    h_bl, w_bl = bl_planes[0].shape
    info = UpsampleInfo(w_bl, h_bl, w_el, h_el)
    got = kern.upsample_frame(bl_planes, w_el, h_el, bit_depth=8)
    mats = []           # the band matrices, float32 on the card
    for c, (p, g) in enumerate(zip(bl_planes, got)):
        ix, cx, iy, cy = kern.axis_plans(tuple(p.shape), g.shape[1],
                                         g.shape[0], min(c, 1), info)
        mats.append([torch.as_tensor(m, dtype=torch.float32,
                                     device=p.device)
                     for m in (x3.band_matrix(ix, cx, p.shape[1]),
                               np.ascontiguousarray(
                                   x3.band_matrix(iy, cy, p.shape[0]).T))])

    def library():
        return [upsample_plane_mm(p, *m, bit_depth=8)
                for p, m in zip(bl_planes, mats)]
    want = upsample_frame([p.cpu().numpy() for p in bl_planes], w_el, h_el,
                          bit_depth=8)
    err = max(_max_diff(got, x3_plain_frame(kern, bl_planes, w_el, h_el)),
              max(int(np.abs(g.cpu().numpy().astype(np.int64) - w).max())
                  for g, w in zip(got, want)))
    lib_err = _max_diff(library(), got)
    ms = cuda_ms(lambda: kern.upsample_frame(bl_planes, w_el, h_el,
                                             bit_depth=8))
    plain_ms = cuda_ms(lambda: x3_plain_frame(kern, bl_planes, w_el, h_el))
    library_ms = cuda_ms(library)
    def run():
        return kern.upsample_frame(bl_planes, w_el, h_el, bit_depth=8)
    device_ms = x3_device_ms(run)
    flush = torch.ones(L2_FLUSH_BYTES // 4, dtype=torch.int32,
                       device=bl_planes[0].device)
    cold_ms = x3_device_ms(run, before=flush.sum)
    del flush
    base = sum(p.numel() * 4 for p in bl_planes)
    byts = base + sum(g.numel() * 4 for g in got)
    ops = 0
    for c, (p, g) in enumerate(zip(bl_planes, got)):
        taps = 8 if c == 0 else 4
        ops += 2 * taps * (p.shape[0] * g.shape[1] + g.numel())
    b = bound(dict(bytes=byts, ops=ops))
    return dict(max_abs_err=err, library_err=lib_err, ms=ms,
                plain_ms=plain_ms, library_ms=library_ms,
                device_ms=device_ms, device_cold_ms=cold_ms,
                gbps=byts / device_ms / 1e6, cold_gbps=byts / cold_ms / 1e6,
                bound_share=b["bound_ms"] / device_ms,
                cold_bound_share=b["bound_ms"] / cold_ms,
                base_bytes=base,
                bytes=byts, ops=ops, **b)


# ---------------------------------------------------------------------------
# phase 8: the variants no bench stream uses (weighted prediction, scaling
# lists, PCM, per-CTB deblocking maps, Python front-end plans, encryption)
# ---------------------------------------------------------------------------

VARIANTS_STREAM = "port_variants_1080p.265"    # tools/port_streams.py
VARIANTS_FRAMES = 8
ENCRYPTED_STREAM = "port_encrypted_480p.265"
ENCRYPTED_FRAMES = 8
ENCRYPT_PARAMS = 15                            # HEVC_CRYPTO_ON
VARIANT_RUNS = 2


def port_stream(name):
    with open(os.path.join(ROOT, "streams", name), "rb") as f:
        return f.read()


def decode_encrypted(data):
    """The encrypted stream through Decoder(encrypt_params=15) (the
    Python walker with the port's keystream; the frames on the card by
    default), every frame fetched to the host; raises unless every frame
    came out with every plane's MD5 matching.  -> (wall seconds, launches
    per kernel, H2D copies, the decoder).  The counters are set to 0 once
    the decoder is built."""
    import torch
    from openhevc_tpu_torch.decoder.frontend import Decoder
    from openhevc_tpu_torch.torch_backend import device
    dec = Decoder(check_md5=True, encrypt_params=ENCRYPT_PARAMS)
    torch.cuda.synchronize()
    device.reset_launches()
    t = time.time()
    frames = dec.decode_stream(data)
    for f in frames:
        if [tuple(p.shape) for p in f.host_planes()] != _shapes(480, 832):
            raise AssertionError("encrypted decode: unexpected shapes")
    torch.cuda.synchronize()
    wall = time.time() - t
    n = ENCRYPTED_FRAMES
    if len(frames) != n or dec.md5_ok != 3 * n or dec.md5_fail:
        raise AssertionError(
            f"encrypted decode: {len(frames)} frames of {n}, md5_ok="
            f"{dec.md5_ok} md5_fail={dec.md5_fail}")
    if frames[0].planes[0].device.type != "cuda":
        raise AssertionError("encrypted decode: frames not on the card")
    return wall, device.launches(), device.h2d_copies(), dec


# what phase 8 holds on the card, a kernel at a time
VARIANT_CALLS = {
    k: ["the I, first P and first B frames' calls of port_variants_1080p "
        "(weighted prediction, scaling lists, PCM, per-CTB deblocking maps), "
        "from the native and from the Python front-end's plans"]
    for k in ("intra", "mc", "paint", "filter")}
VARIANT_CALLS["filter"].append(
    "per-CTB map grids: " + "; ".join(
        f"{CFMT[c]} depth {bd} {H}x{W}" for H, W, bd, c in K4_MAPS))


def run_variants(rng, dev, path_launches):
    """Phase 8.  -> {kernel: max abs difference of its checks}."""
    import torch
    errs = {"intra": 0, "mc": 0, "paint": 0, "filter": check_k4_maps(rng,
                                                                      dev)}
    torch.cuda.synchronize()
    print(f"variants kernels filter={errs['filter']} (per-CTB map grids: "
          + "; ".join(f"{CFMT[c]} depth {bd} {H}x{W}"
                      for H, W, bd, c in K4_MAPS) + ")", flush=True)
    vdata = port_stream(VARIANTS_STREAM)
    clip = check_stream_calls(VARIANTS_STREAM, vdata, 3)
    print("variants kernels_clip stream=port_variants_1080p (I, P, B) "
          + " ".join(f"{k}={v}" for k, v in clip.items()), flush=True)
    # the same frames from the Python front-end's plans: MC batches and
    # weights from compile_plan, K1 metadata from split_meta_bands, the
    # residuals from resid_batches, the PCM canvas from the PcmOps
    pclip = check_stream_calls(VARIANTS_STREAM, vdata, 3, use_native=False)
    print("variants kernels_clip stream=port_variants_1080p (I, P, B) "
          "front_end=python " + " ".join(f"{k}={v}"
                                         for k, v in pclip.items()),
          flush=True)
    errs = {k: max(v, clip[k], pclip[k]) for k, v in errs.items()}
    edata = port_stream(ENCRYPTED_STREAM)
    with refuse_plain():
        poc = check_no_sync(vdata, slice_type=0)
        print(f"variants sync_debug=error over the dispatch of "
              f"port_variants_1080p's B frame POC {poc}: no host wait",
              flush=True)
        shapes = _shapes(1080, 1920)
        # the dispatcher's host seconds in the weighted combine and in the
        # per-CTB map gathers (frame_step's own lookups of both names)
        from openhevc_tpu_torch.torch_backend import frame_step as fs
        saved = (fs.weighted_combine, fs._expand)
        for run in range(VARIANT_RUNS):
            cost = {"weighted_combine_s": 0.0, "map_expand_s": 0.0}
            fs.weighted_combine = _timed(saved[0], cost,
                                         "weighted_combine_s")
            fs._expand = _timed(saved[1], cost, "map_expand_s")
            try:
                pwall, pc, h2d, pdec, busy = decode_pipelined(
                    vdata, VARIANTS_FRAMES, shapes)
            finally:
                fs.weighted_combine, fs._expand = saved
            n = VARIANTS_FRAMES
            busy.update({k.replace("_s", "_ms_per_frame"): v * 1e3 / n
                         for k, v in cost.items()})
            print(f"variants pipeline port_variants_1080p run={run + 1} "
                  f"frames={n} md5_ok={pdec.md5_ok} "
                  f"md5_fail={pdec.md5_fail} wall_s={pwall:.3f} "
                  f"fps={n / pwall:.3f} launches={json.dumps(pc)} "
                  f"h2d_per_frame={h2d / n:.3f} " + " ".join(
                      f"{k}={v:.3f}" for k, v in busy.items()), flush=True)
            if h2d != n or pc["intra"] != n or pc["filter"] != n or \
                    min(pc.values()) <= 0:
                raise AssertionError(f"variants pipeline: {h2d} uploads "
                                     f"and launches {pc} for {n} frames")
            path_launches[f"pipeline port_variants_1080p run {run + 1}"] = pc
        for run in range(VARIANT_RUNS):
            ewall, ec, h2d, edec = decode_encrypted(edata)
            n = ENCRYPTED_FRAMES
            print(f"variants encrypted port_encrypted_480p run={run + 1} "
                  f"frames={n} md5_ok={edec.md5_ok} "
                  f"md5_fail={edec.md5_fail} wall_s={ewall:.3f} "
                  f"fps={n / ewall:.3f} launches={json.dumps(ec)} "
                  f"h2d_per_frame={h2d / n:.3f} "
                  f"dispatch_s={edec.stats.decode_time_s:.3f}", flush=True)
            if h2d != n or ec["intra"] != n or ec["filter"] != n or \
                    min(ec.values()) <= 0:
                raise AssertionError(f"encrypted decode: {h2d} uploads "
                                     f"and launches {ec} for {n} frames")
            path_launches[f"encrypted port_encrypted_480p run {run + 1}"] = ec
    return errs


# ---------------------------------------------------------------------------
# phase 9: the entry points users call (API, API layer chain, CLI, C shim)
# ---------------------------------------------------------------------------

def access_units(data):
    """The stream cut into access units by the port's HevcParser, the
    parameter sets with the first, as a player's demuxer delivers them."""
    from openhevc_tpu_torch.parser import HevcParser
    infos = HevcParser().iter_access_units(data)
    offs = [i.offset for i in infos] + [len(data)]
    return [data[:offs[1]]] + [data[offs[k]:offs[k + 1]]
                               for k in range(1, len(offs) - 1)]


class frame_uploads:
    """Inside: every CudaBackend.decode_frame records the host-to-device
    copies it made (``per_frame``) and the time of the first one."""

    def __enter__(self):
        from openhevc_tpu_torch.torch_backend import backend, device
        self.cls, self.inner = backend.CudaBackend, \
            backend.CudaBackend.decode_frame
        self.per_frame, self.t_first = [], None
        inner, per_frame = self.inner, self.per_frame

        def decode_frame(be, plan, dpb):
            if self.t_first is None:
                self.t_first = time.time()
            n = device.h2d_copies()
            out = inner(be, plan, dpb)
            per_frame.append(device.h2d_copies() - n)
            return out
        self.cls.decode_frame = decode_frame
        return self

    def __exit__(self, *exc):
        self.cls.decode_frame = self.inner


def report_counts():
    """Run in a subprocess entry point (the CLI, the C shim's embedded
    interpreter) by the sitecustomize that entry_points writes: prints one
    ``entry_counts {...}`` line with the process's kernel launches, its
    host-to-device copies a frame, the seconds from its first frame and
    the clock times at which the sitecustomize started, the port was
    imported, the first CudaBackend was built, its first prepare_host
    returned and PipelinedDecoder handed out its first frame (the CLI),
    when the API closes its decoder (the shim never finalizes Python) or
    at exit (the CLI), whichever comes first."""
    import atexit
    marks = {"site_at": time.time()}
    from openhevc_tpu_torch.api import openhevc as api
    from openhevc_tpu_torch.runtime import pipeline
    from openhevc_tpu_torch.torch_backend import device
    from openhevc_tpu_torch.torch_backend.backend import CudaBackend
    marks["imported_at"] = time.time()
    uploads = frame_uploads().__enter__()
    done, first_out = [], []
    frames = pipeline.PipelinedDecoder.frames
    init, prepare = CudaBackend.__init__, CudaBackend.prepare_host

    def init_timed(self, *a, **kw):
        init(self, *a, **kw)
        marks.setdefault("backend_at", time.time())

    def prepare_timed(self, *a, **kw):
        out = prepare(self, *a, **kw)
        marks.setdefault("prepared_at", time.time())
        return out
    CudaBackend.__init__, CudaBackend.prepare_host = init_timed, prepare_timed

    def frames_timed(self, *a, **kw):
        it = frames(self, *a, **kw)
        try:
            for f in it:
                if not first_out:
                    first_out.append(time.time())
                yield f
        finally:
            it.close()
    pipeline.PipelinedDecoder.frames = frames_timed

    def report():
        if done:
            return
        done.append(1)
        t = uploads.t_first
        print("entry_counts " + json.dumps(dict(
            launches=device.launches(), h2d_per_frame=uploads.per_frame,
            decode_s=None if t is None else time.time() - t,
            first_frame_at=first_out[0] if first_out else None, **marks)),
            flush=True)
    atexit.register(report)
    close = api.OpenHevcDecoder.close

    def closing(dec):
        close(dec)
        report()
    api.OpenHevcDecoder.close = closing


# the sitecustomize of the subprocess entry points: report_counts, then
# any sitecustomize of the installation further down the path
SITECUSTOMIZE = """\
import importlib.machinery, importlib.util, os, sys
import chip_smoke
chip_smoke.report_counts()
_here = os.path.dirname(os.path.abspath(__file__))
_spec = importlib.machinery.PathFinder.find_spec(
    "sitecustomize", [p for p in sys.path
                      if os.path.abspath(p or ".") != _here])
if _spec is not None:
    _spec.loader.exec_module(importlib.util.module_from_spec(_spec))
"""


def read_counts(out):
    """The ``entry_counts`` line of a subprocess's standard output."""
    (line,) = [ln for ln in out.splitlines()
               if ln.startswith("entry_counts ")]
    return json.loads(line[len("entry_counts "):])


def check_counts(path, counts, n_frames, per_frame):
    """One H2D copy a frame (the first frame of a fresh process also
    uploads the constant tables), K1 and K4 once a frame, every kernel
    launched."""
    if (len(per_frame) != n_frames or per_frame[0] < 1
            or any(n != 1 for n in per_frame[1:])
            or counts["intra"] != n_frames or counts["filter"] != n_frames
            or min(counts.values()) <= 0):
        raise AssertionError(f"{path}: uploads a frame {per_frame}, "
                             f"launches {counts} for {n_frames} frames")


def api_decode(aus, n_out, setup=None):
    """The access units through libOpenHevcDecode on an OpenHevcDecoder()
    (the card) with MD5 on, every picture taken by libOpenHevcGetOutput,
    then the EOS drain.  Raises unless n_out pictures came out, every MD5
    of every decoded layer matched and nothing was dropped.  -> (output
    bytes, wall seconds, launches, uploads a frame, the decoder)."""
    import torch
    from openhevc_tpu_torch import api
    from openhevc_tpu_torch.torch_backend import device
    dec = api.libOpenHevcInit(1, 1)
    api.libOpenHevcSetCheckMD5(dec, 1)
    if setup is not None:
        setup(dec)
    api.libOpenHevcStartDecoder(dec)
    torch.cuda.synchronize()
    device.reset_launches()
    out = []

    def take():
        o = api.libOpenHevcGetOutput(dec, 1)
        out.extend((o.pvY.tobytes(), o.pvU.tobytes(), o.pvV.tobytes()))
    with frame_uploads() as up:
        t = time.time()
        for au in aus:
            if api.libOpenHevcDecode(dec, au, len(au)):
                take()
        while api.libOpenHevcDecode(dec, b"", 0):
            take()
        torch.cuda.synchronize()
        wall = time.time() - t
    for d in [dec] + ([dec._el] if dec._el is not None else []):
        if d.md5_fail or d.error_count or d.md5_ok != 3 * n_out:
            raise AssertionError(
                f"API: layer {d.fe.layer_id} md5_ok={d.md5_ok} md5_fail="
                f"{d.md5_fail} errors={d.error_count}")
    if len(out) != 3 * n_out:
        raise AssertionError(f"API: {len(out) // 3} pictures of {n_out}")
    counts = device.launches()
    api.libOpenHevcClose(dec)
    return b"".join(out), wall, counts, up.per_frame, dec


def _subprocess_env(hook_dir):
    """The running interpreter's path, behind the counting hook and the
    checkout, for a subprocess or an embedded interpreter."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [hook_dir, ROOT] + [p for p in sys.path if p and p != ROOT])
    env.pop("OPENHEVC_TORCH_BACKEND", None)      # unset: the card
    return env


def run_entry(cmd, env, path, n_frames, want_yuv, yuv_path):
    """A subprocess entry point: rc 0, its counts line, its YUV
    byte-identical to the API's.  -> (stdout, stderr, wall, counts); the
    counts carry ``first_frame_s``, the seconds from the process's launch
    to its first frame out of PipelinedDecoder (None where none ran)."""
    t = time.time()
    r = subprocess.run(cmd, env=env, capture_output=True, text=True,
                       timeout=600)
    wall = time.time() - t
    if r.returncode != 0:
        raise AssertionError(f"{path}: rc {r.returncode}\n{r.stdout[-3000:]}"
                             f"\n{r.stderr[-3000:]}")
    c = read_counts(r.stdout)
    c["first_frame_s"] = (None if c["first_frame_at"] is None
                          else c["first_frame_at"] - t)
    # the wait before the first frame, split at the marks report_counts
    # took: interpreter start, the port's import, up to the first backend
    # (the CLI's start and the parse), its first prepare, then the first
    # frame's device work and fetch (the d5 probe's included)
    at = [t] + [c.get(k) for k in ("site_at", "imported_at", "backend_at",
                                   "prepared_at", "first_frame_at")]
    c["split_s"] = {k: (None if None in (a, b) else round(b - a, 3))
                    for k, a, b in zip(("start", "import", "to_backend",
                                        "first_prepare", "first_frame"),
                                       at, at[1:])}
    check_counts(path, c["launches"], n_frames, c["h2d_per_frame"])
    with open(yuv_path, "rb") as f:
        if f.read() != want_yuv:
            raise AssertionError(f"{path}: YUV differs from the API's")
    return r.stdout, r.stderr, wall, c


def entry_api(data, path_launches):
    """The clip through the API, one access unit a call.  -> (its access
    units, the API's output bytes, the picture's width and height)."""
    from openhevc_tpu_torch import api
    aus = access_units(data)
    n = FRAMES
    if len(aus) != n:
        raise AssertionError(f"HevcParser: {len(aus)} access units")
    print(f"entry_points version {api.libOpenHevcVersion()}", flush=True)
    with refuse_plain():
        yuv, wall, counts, per_frame, dec = api_decode(aus, n)
    check_counts("API", counts, n, per_frame)
    info = dec.get_picture_info()
    print(f"entry_points api 1080p_main frames={n} md5_ok={dec.md5_ok} "
          f"md5_fail={dec.md5_fail} errors={dec.error_count} "
          f"wall_s={wall:.3f} fps={n / wall:.3f} "
          f"launches={json.dumps(counts)} h2d_per_frame={per_frame}",
          flush=True)
    path_launches["api 1080p_main"] = counts
    return aus, yuv, (info.nWidth, info.nHeight)


def entry_api_shvc(path_launches):
    """Both layers of the SHVC stream through the API's layer chain, the
    enhancement layer shown, X3 on the card through its kernel."""
    from openhevc_tpu_torch.torch_backend import device
    from openhevc_tpu_torch.torch_backend.upsample import CudaUpsampler
    where, calls = set(), []
    inner = CudaUpsampler.upsample_frame

    def seen(self, planes, *a, **kw):
        out = inner(self, planes, *a, **kw)
        where.update(p.device.type for p in list(planes) + out)
        calls.append(1)
        return out

    def el_view(d):
        d.set_active_decoders(1)
        d.set_view_layers(1)
    CudaUpsampler.upsample_frame = seen
    try:
        with refuse_plain():
            yuv, wall, counts, per_frame, dec = api_decode(
                access_units(bench_stream("shvc_4k60")), SHVC_PICTURES,
                el_view)
    finally:
        CudaUpsampler.upsample_frame = inner
    x3n = device.x3_launches()
    h, w = SHVC_EL[0]
    if len(yuv) != SHVC_PICTURES * h * w * 3 // 2:
        raise AssertionError("API SHVC: unexpected picture size")
    if not calls or where != {"cuda"} or \
            min(counts.values()) <= 0 or x3n != len(calls):
        raise AssertionError(f"API SHVC: {len(calls)} inter-layer "
                             f"upsamples on {sorted(where)}, launches "
                             f"{counts}, X3 launches {x3n}")
    print(f"entry_points api_shvc shvc_4k60 el_pictures={SHVC_PICTURES} "
          f"md5_ok bl={dec.md5_ok} el={dec._el.md5_ok} "
          f"md5_fail={dec.md5_fail + dec._el.md5_fail} "
          f"wall_s={wall:.3f} fps_el={SHVC_PICTURES / wall:.3f} "
          f"launches={json.dumps(counts)} x3_calls={len(calls)} "
          f"x3_launches={x3n} h2d_per_frame={per_frame}", flush=True)
    path_launches["api_shvc shvc_4k60"] = dict(counts, upsample=x3n)


CAP_STORE_RUNS = 3             # CLI pairs: no store, then the cap store


def entry_subprocesses(stream_path, data, aus, yuv, size, path_launches):
    """The CLI on annex-B and on the same stream muxed to MP4, then the C
    shim through tools/abi_driver.c, each a process of its own whose YUV
    must be the API's bytes."""
    import tempfile
    from openhevc_tpu_torch import native
    from openhevc_tpu_torch.formats import mux_mp4
    n = len(aus)
    with tempfile.TemporaryDirectory() as tmp:
        hook = os.path.join(tmp, "hook")
        os.mkdir(hook)
        with open(os.path.join(hook, "sitecustomize.py"), "w") as f:
            f.write(SITECUSTOMIZE)
        env = _subprocess_env(hook)

        mp4 = os.path.join(tmp, "in.mp4")
        with open(mp4, "wb") as f:
            f.write(mux_mp4(data, *size))
        for kind, inp in (("annexb", stream_path), ("mp4", mp4)):
            out = os.path.join(tmp, f"cli_{kind}.yuv")
            so, se, wall, c = run_entry(
                [sys.executable, "-m", "openhevc_tpu_torch.cli", "-i", inp,
                 "-o", out], env, f"CLI {kind}", n, yuv, out)
            os.remove(out)
            if f"MD5 check: {3 * n} correct, 0 incorrect" not in se or \
                    f"frame= {n} " not in so:
                raise AssertionError(f"CLI {kind}: {so[-500:]} {se[-500:]}")
            fps = [ln for ln in so.splitlines() if ln.startswith("frame=")]
            print(f"entry_points cli 1080p_main {kind} rc=0 {fps[0]} "
                  f"md5='{3 * n} correct, 0 incorrect' "
                  f"process_wall_s={wall:.3f} "
                  f"first_frame_s={c['first_frame_s']:.3f} "
                  f"split_s={json.dumps(c['split_s'])} "
                  f"launches={json.dumps(c['launches'])} "
                  f"h2d_per_frame={c['h2d_per_frame']} yuv=api", flush=True)
            path_launches[f"cli 1080p_main {kind}"] = c["launches"]

        # the CLI on one cap store (a temporary file), each run behind a
        # run without it: the first store run starts from nothing, the
        # later ones at the caps it saved (a d5 that is on as well; the
        # clip's probe turns d5 off, which is not stored, so every run
        # probes again)
        store = os.path.join(tmp, "cap_store.json")
        for run in range(1, CAP_STORE_RUNS + 1):
            for label, renv in (("no_store", env),
                                ("cap_store",
                                 dict(env, OPENHEVC_CAP_STORE=store))):
                out = os.path.join(tmp, f"cli_{label}{run}.yuv")
                so, se, wall, c = run_entry(
                    [sys.executable, "-m", "openhevc_tpu_torch.cli", "-i",
                     stream_path, "-o", out], renv,
                    f"CLI {label} run {run}", n, yuv, out)
                os.remove(out)
                if f"MD5 check: {3 * n} correct, 0 incorrect" not in se:
                    raise AssertionError(f"CLI {label} run {run}: "
                                         f"{se[-500:]}")
                extra = ""
                if label == "cap_store":
                    with open(store) as f:
                        keys = json.load(f)["keys"]
                    (key,) = keys
                    if not key.endswith(":openhevc_tpu_torch"):
                        raise AssertionError(f"cap store: key {key}")
                    extra = (f"store_key={key} "
                             f"d5={json.dumps(keys[key].get('_dwire'))} ")
                fps = [ln for ln in so.splitlines()
                       if ln.startswith("frame=")]
                print(f"entry_points cli 1080p_main annexb {label} "
                      f"run={run} rc=0 {fps[0]} "
                      f"md5='{3 * n} correct, 0 incorrect' "
                      f"process_wall_s={wall:.3f} "
                      f"first_frame_s={c['first_frame_s']:.3f} "
                      f"split_s={json.dumps(c['split_s'])} {extra}"
                      f"launches={json.dumps(c['launches'])} yuv=api",
                      flush=True)
                path_launches[f"cli 1080p_main {label} run {run}"] = \
                    c["launches"]

        t = time.time()
        lib = native.build_abi()
        drv = os.path.join(tmp, "abi_driver")
        libdir = os.path.dirname(lib)
        subprocess.run(["gcc", "-O1", os.path.join(ROOT, "tools",
                                                   "abi_driver.c"),
                        "-o", drv, f"-L{libdir}", "-lLibOpenHevcWrapper",
                        f"-Wl,-rpath,{libdir}"], check=True, timeout=300)
        build_s = time.time() - t
        auf = os.path.join(tmp, "in.aus")
        with open(auf, "wb") as f:
            for au in aus:
                f.write(len(au).to_bytes(4, "little"))
                f.write(au)
        out = os.path.join(tmp, "abi.yuv")
        so, se, wall, c = run_entry([drv, auf, out, "md5"], env, "ABI", n,
                                    yuv, out)
        if f"frames={n}" not in so or "(openhevc_tpu_torch)" not in so:
            raise AssertionError(f"ABI: {so[-500:]}")
        (version,) = [ln for ln in so.splitlines() if "OpenHEVC" in ln]
        print(f"entry_points abi 1080p_main frames={n} "
              f"version='{version}' build_s={build_s:.3f} "
              f"process_wall_s={wall:.3f} decode_s={c['decode_s']:.3f} "
              f"fps={n / c['decode_s']:.3f} "
              f"launches={json.dumps(c['launches'])} "
              f"h2d_per_frame={c['h2d_per_frame']} yuv=api", flush=True)
        path_launches["abi 1080p_main"] = c["launches"]


def entry_points(data, path_launches):
    """Phase 9.  The 1080p clip through the API, the CLI (annex-B and MP4)
    and the C shim, and both layers of the SHVC stream through the API's
    layer chain, on the card."""
    aus, yuv, size = entry_api(data, path_launches)
    entry_api_shvc(path_launches)
    entry_subprocesses(STREAM, data, aus, yuv, size, path_launches)


# ---------------------------------------------------------------------------
# phase 10: multi-device decode on one card (closed-GOP segments from two
# threads, an open GOP over a device schedule, K4 on CTB-row bands), the d5
# output wire, and dispatches held against a sleep queued on the device
# ---------------------------------------------------------------------------

MESH_DEVICES = ["cuda:0", "cuda:0"]     # one card: both "devices" are it
MESH_BANDS = (2, 4)                     # sp bands: make_mesh of 4, 8 devices
GATE_MS = 500                           # the gate ahead of both first K1s
SLEEP_MS = 2000                         # the sleep ahead of a dispatch


def sleep_cycles(ms):
    """Cycles of torch.cuda._sleep that last about ms on this card
    (calibrated with CUDA events)."""
    import torch
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    a.record()
    torch.cuda._sleep(10 ** 8)
    b.record()
    torch.cuda.synchronize()
    return int(10 ** 8 * ms / a.elapsed_time(b))


class K1Spans:
    """Inside: CUDA events before and after every K1 launch, on the
    launching stream, from any thread.  With gate: each thread's first K1
    waits at a host barrier until the other segment's thread reaches its
    own first K1; the barrier then queues a sleep of GATE_MS on a side
    stream and one event after it, and both streams wait on that event
    before their first K1, so that both grids start together on the
    device.  overlaps() counts pairs of K1 launches on two streams whose
    spans meet."""

    def __init__(self, gate=False):
        import threading
        import torch
        self.spans, self.lock = [], threading.Lock()
        self.gated = set()
        self.gate_event = None
        self.barrier = None
        if gate:
            side = torch.cuda.Stream()
            cycles = sleep_cycles(GATE_MS)

            def arm():
                with torch.cuda.stream(side):
                    torch.cuda._sleep(cycles)
                    self.gate_event = torch.cuda.Event()
                    self.gate_event.record(side)
            self.barrier = threading.Barrier(2, action=arm, timeout=120)

    def __enter__(self):
        import torch
        from openhevc_tpu_torch.torch_backend import cuda_lib
        self.base = torch.cuda.Event(enable_timing=True)
        self.base.record()
        self.real = real = cuda_lib.launch

        def launch(name, dev, *args):
            if name != "ohk_intra":
                return real(name, dev, *args)
            s = torch.cuda.current_stream(dev)
            if self.barrier is not None and s.cuda_stream not in self.gated:
                self.gated.add(s.cuda_stream)
                self.barrier.wait()
                s.wait_event(self.gate_event)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record(s)
            real(name, dev, *args)
            b.record(s)
            with self.lock:
                self.spans.append((s.cuda_stream, a, b))
        cuda_lib.launch = launch
        return self

    def __exit__(self, *exc):
        from openhevc_tpu_torch.torch_backend import cuda_lib
        cuda_lib.launch = self.real

    def overlaps(self):
        import torch
        torch.cuda.synchronize()
        iv = [(s, self.base.elapsed_time(a), self.base.elapsed_time(b))
              for s, a, b in self.spans]
        return sum(1 for i, (s0, a0, b0) in enumerate(iv)
                   for (s1, a1, b1) in iv[i + 1:]
                   if s0 != s1 and a0 < b1 and a1 < b0)


def _host(frames):
    return [[np.asarray(p, np.int32) for p in f.host_planes()]
            for f in frames]


def _same_planes(got, want, what):
    if len(got) != len(want) or any(
            not np.array_equal(g, w) for gf, wf in zip(got, want)
            for g, w in zip(gf, wf)):
        raise AssertionError(f"{what}: planes differ from the serial decode")


def mesh_decode(data, devices, n, gate=False):
    """data through MeshDecoder(devices, check_md5=True), K1 spans
    recorded.  -> (frames' host planes, wall seconds, launches, K1 span
    overlaps).  Raises unless n frames came out with every MD5."""
    import torch
    from openhevc_tpu_torch.parallel import MeshDecoder
    from openhevc_tpu_torch.torch_backend import device
    mdec = MeshDecoder(devices, check_md5=True)
    torch.cuda.synchronize()
    device.reset_launches()
    with K1Spans(gate) as spans:
        t = time.time()
        frames = mdec.decode_stream(data)
        torch.cuda.synchronize()
        wall = time.time() - t
    counts = device.launches()
    if len(frames) != n or mdec.md5_ok != 3 * n or mdec.md5_fail:
        raise AssertionError(f"mesh decode on {devices}: {len(frames)} "
                             f"frames, md5_ok={mdec.md5_ok} "
                             f"md5_fail={mdec.md5_fail}")
    return ([[p for p in f.planes] for f in frames], wall, counts,
            spans.overlaps())


# CUDA runtime and driver calls that make the host wait for the device
SYNC_CALLS = re.compile(r"Synchronize|^cu(da)?Memcpy(?!.*Async)|"
                        r"^cu(da)?Memset(?!.*Async)|^cudaFree|^cuMemFree")


def launch_queue_depth(limit=4096):
    """How many kernel launches a stream takes behind a stalled one before
    cudaLaunchKernel blocks: a sleep of SLEEP_MS queued, then one-element
    adds launched until one takes longer than 20 ms to return."""
    import torch
    x = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    torch.cuda._sleep(sleep_cycles(SLEEP_MS))
    n = 0
    while n < limit:
        t = time.perf_counter()
        x.add_(1)
        if time.perf_counter() - t > 0.02:
            break
        n += 1
    torch.cuda.synchronize()
    return n


def check_no_wait(data, pick, what, dwire=None, n_pics=3):
    """The dispatch of the first picture among data's first n_pics that
    pick(plan) selects (Decoder._reconstruct: plan preparation, upload,
    frame step, the start of the output copy), on the backend's compute
    stream with SLEEP_MS of torch.cuda._sleep queued there just before
    it, under torch.profiler, which records every CUDA runtime and driver
    call the dispatch makes (CUPTI; independent of set_sync_debug_mode).
    It must make no call that waits for the device (SYNC_CALLS), and
    outside cudaLaunchKernel its host time must stay under half the
    sleep.  Whether it returned before the sleep ended is reported: a
    dispatch of more launches than the stream's launch queue holds
    (launch_queue_depth) blocks in cudaLaunchKernel until the device
    drains the queue.  dwire: the d5 caps to force.  The frames decode
    with every MD5.  -> (POC, dispatch host seconds, returned before the
    sleep ended, the frame's wire format, launches, seconds blocked in
    cudaLaunchKernel)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from openhevc_tpu_torch.decoder.frontend import Decoder
    dec = Decoder(check_md5=True)
    if dwire is not None:
        dec.backend._dwire = dwire
    cycles = sleep_cycles(SLEEP_MS)
    inner = dec._reconstruct
    seen = []

    def guarded(plan):
        if seen or not pick(plan):
            return inner(plan)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            torch.cuda._sleep(cycles)
            slept = torch.cuda.Event()
            slept.record()
            t = time.perf_counter()
            frame = inner(plan)
            dt = time.perf_counter() - t
            early = not slept.query()
        calls = {e.key: e for e in prof.key_averages()}
        sync = sorted(k for k in calls if SYNC_CALLS.search(k))
        launch = calls.get("cudaLaunchKernel")
        n = launch.count if launch is not None else 0
        blocked = launch.self_cpu_time_total / 1e6 if launch else 0.0
        seen.append((plan.poc, dt, early, frame.wire_fmt, n, blocked,
                     sync))
        return frame
    dec._reconstruct = guarded
    with torch.cuda.stream(dec.backend.compute_stream):
        frames = dec.decode_stream(_first_pictures(data, n_pics))
        for f in frames:
            f.host_planes()
    torch.cuda.synchronize()
    if len(seen) != 1:
        raise AssertionError(f"no-wait check {what}: no frame picked")
    poc, dt, early, fmt, n, blocked, sync = seen[0]
    print(f"mesh no_wait {what}: POC {poc} dispatch {dt * 1e3:.3f} ms host, "
          f"{n} kernel launches, {blocked * 1e3:.3f} ms of it blocked in "
          f"cudaLaunchKernel, returned {'before' if early else 'after'} "
          f"the {SLEEP_MS} ms device sleep ahead of it ended; calls that "
          f"wait for the device: {sync or 'none'} (wire "
          f"{fmt[0] if fmt else 'raw'})", flush=True)
    if sync or dt - blocked > SLEEP_MS / 2e3:
        raise AssertionError(f"no-wait check {what}: the dispatch waited "
                             f"for the device ({sync}, {dt - blocked:.3f} s "
                             f"outside cudaLaunchKernel)")
    if dec.md5_ok != 3 * n_pics or dec.md5_fail:
        raise AssertionError(f"no-wait check {what}: md5_ok={dec.md5_ok}")
    return poc, dt, early, fmt, n, blocked


def d5_bytes_check(frames, caps_of, what):
    """Each d5 frame's wire, as the card made it, against d5_wire on the
    CPU (its plain run) over the same planes: byte-identical.  -> frames
    checked."""
    import torch
    from openhevc_tpu_torch.torch_backend.frame_step import d5_wire
    n = 0
    for f in frames:
        if not (f.wire_fmt and f.wire_fmt[0] == "d5"):
            continue
        got = f.wire.cpu().numpy()
        want = d5_wire([torch.from_numpy(np.asarray(p, np.int32))
                        for p in f.host_planes()], caps_of(f)).numpy()
        if got.tobytes() != want.tobytes():
            raise AssertionError(f"d5 {what}: POC {f.poc}'s wire differs "
                                 f"from the plain d5 version's")
        n += 1
    return n


def mesh_d5(streams):
    """PipelinedDecoder() with check_md5 on each of streams {name: (data,
    frames, serial host planes)}: the probe's decision; where it turns d5
    on, every frame after the first dispatched shipped d5 and each d5 wire
    equals the plain version's bytes; where it does not, d5 forced once
    with the caps the probe would have set (Decoder, 3 pictures): wires
    equal to the plain version's, planes equal to the serial decode's;
    then caps of 8 forced, whose overflow falls back to the int32 planes:
    the same planes, and the caps grow.  -> {name: decision}."""
    import torch
    from openhevc_tpu_torch.decoder.frontend import Decoder
    from openhevc_tpu_torch.runtime import PipelinedDecoder
    from openhevc_tpu_torch.torch_backend.backend import d5_probe
    out = {}
    for name, (sdata, n, serial) in streams.items():
        dec = PipelinedDecoder(check_md5=True)
        t = time.time()
        frames = []
        for f in dec.frames(sdata):
            f.host_planes()
            frames.append(f)
        torch.cuda.synchronize()
        wall = time.time() - t
        if len(frames) != n or dec.md5_ok != 3 * n or dec.md5_fail:
            raise AssertionError(f"d5 {name}: {len(frames)} frames, md5_ok="
                                 f"{dec.md5_ok} md5_fail={dec.md5_fail}")
        _same_planes(_host(frames), serial, f"d5 {name} pipelined")
        decision = dec.backend._dwire
        d5 = [f.poc for f in frames if f.wire_fmt and f.wire_fmt[0] == "d5"]
        frac, caps = d5_probe(frames[0].host_planes())
        print(f"mesh d5 {name}: probe escape share {frac:.5f} -> "
              f"{'on, caps ' + str(decision) if decision else 'off'}; "
              f"frames on the d5 wire {len(d5)} of {n} (fps "
              f"{n / wall:.3f}, every MD5)", flush=True)
        if isinstance(decision, tuple):
            if len(d5) != n - 1 or 0 in d5:
                raise AssertionError(f"d5 {name}: POCs {d5} shipped d5")
            k = d5_bytes_check(frames, lambda f: f.wire_fmt[1], name)
            print(f"mesh d5 {name}: {k} d5 wires byte-identical to the "
                  f"plain version's", flush=True)
        else:
            for label, dw in (("forced", caps), ("overflow",
                                                 ((8, 8),) * 3)):
                fdec = Decoder(check_md5=True)
                fdec.backend._dwire = dw
                with torch.cuda.stream(fdec.backend.compute_stream):
                    ff = fdec.decode_stream(_first_pictures(sdata, 3))
                    hp = _host(ff)
                torch.cuda.synchronize()
                if fdec.md5_ok != 9 or fdec.md5_fail:
                    raise AssertionError(f"d5 {name} {label}: md5")
                _same_planes(hp, serial[:3], f"d5 {name} {label}")
                fmts = [f.wire_fmt[1] for f in ff]
                k = d5_bytes_check(ff, lambda f: f.wire_fmt[1],
                                   f"{name} {label}")
                grown = fdec.backend._dwire
                print(f"mesh d5 {name} {label}: caps per frame {fmts}, "
                      f"{k} wires byte-identical to the plain version's, "
                      f"planes equal to the serial decode's; caps after "
                      f"{grown}", flush=True)
                if label == "overflow" and grown[0][0] <= 8:
                    raise AssertionError(f"d5 {name}: caps did not grow")
        out[name] = decision
    return out


def time_wires(planes_host, caps):
    """The d5 wire (with caps) and the raw 8-bit wire of one frame's
    planes on the card (CUDA events).  -> (d5 ms, raw ms, d5 bytes)."""
    import torch
    from openhevc_tpu_torch.torch_backend.frame_step import (d5_wire,
                                                             output_wire)
    planes = [torch.as_tensor(p, device="cuda") for p in planes_host]
    d5 = cuda_ms(lambda: d5_wire(planes, caps))
    raw = cuda_ms(lambda: output_wire(planes, 8))
    return d5, raw, int(d5_wire(planes, caps).numel())


def time_k4_bands(rng, dev):
    """K4 on one random 1080p frame (4:2:0, CTB 64, deblock + SAO +
    restore masks): unbanded and on k bands (filter_bands, all bands on
    this card), each held against the unbanded plain version at tolerance
    0 and timed with CUDA events over the whole stage (slicing, the k
    launches, the stitching).  -> ({"unbanded"|"sp2"|"sp4": ms}, max
    abs difference)."""
    from openhevc_tpu_torch.torch_backend import filter as flt
    planes, grids, sao, rs = k4_frame(rng, dev, 1080, 1920, 8)
    args = (planes, grids, sao, rs)
    kw = dict(bd=8, deblock_on=True, sao_on=True, ctb=64, hs=1, vs=1)
    plain = flt.filter_planes_plain(*args, **kw)
    err = _max_diff(flt.filter_planes(*args, **kw), plain)
    ms = {"unbanded": cuda_ms(lambda: flt.filter_planes(*args, **kw))}
    for k in MESH_BANDS:
        bands = [(dev, None)] * k
        err = max(err, _max_diff(flt.filter_bands(*args, bands, **kw),
                                 plain))
        ms[f"sp{k}"] = cuda_ms(lambda: flt.filter_bands(*args, bands, **kw))
    return ms, err


def run_mesh(rng, dev, data, serial, path_launches):
    """Phase 10.  serial: the clip's host planes from the serial decode.
    -> max abs difference of banded K4 against the plain version."""
    import torch
    from openhevc_tpu_torch.decoder.frontend import Decoder
    from openhevc_tpu_torch.parallel import (dryrun_step, make_mesh,
                                             split_closed_gops)
    from openhevc_tpu_torch.torch_backend import device
    from openhevc_tpu_torch.torch_backend.backend import d5_probe
    n = FRAMES
    doubled = data + data
    t = time.time()
    if len(split_closed_gops(doubled)) != 2:
        raise AssertionError("the doubled clip must split into 2 segments")
    split_s = time.time() - t       # MeshDecoder splits again, each run
    want = {"intra": 2 * n, "mc": 2 * (n - 1), "paint": 2 * (2 * n - 1),
            "filter": 2 * n}
    with refuse_plain():
        # closed-GOP segments: one thread (serial), two threads, and two
        # threads with both first K1s gated to start together
        fps = {}
        for label, devs, gate in (("serial", MESH_DEVICES[:1], False),
                                  ("threads", MESH_DEVICES, False),
                                  ("gated", MESH_DEVICES, True)):
            planes, wall, counts, overlap = mesh_decode(doubled, devs, 2 * n,
                                                        gate)
            _same_planes(planes, serial + serial, f"segments {label}")
            if counts != want:
                raise AssertionError(f"segments {label}: launches {counts}, "
                                     f"want {want}")
            fps[label] = 2 * n / wall
            print(f"mesh segments {label} devices={devs} frames={2 * n} "
                  f"md5_ok={6 * n} wall_s={wall:.3f} fps={fps[label]:.3f} "
                  f"split_s={split_s:.3f} fps_after_split="
                  f"{2 * n / (wall - split_s):.3f} "
                  f"launches={json.dumps(counts)} "
                  f"k1_span_overlaps={overlap}", flush=True)
            if label == "threads":
                path_launches["mesh segments"] = counts
            if label == "gated" and overlap < 1:
                raise AssertionError("segments: the two segments' K1 grids "
                                     "were never in flight at once")
        # one open GOP over a device schedule
        t = time.time()
        split_closed_gops(data)
        split1_s = time.time() - t
        planes, wall, counts, _ = mesh_decode(data, MESH_DEVICES, n)
        _same_planes(planes, serial, "schedule")
        if counts["intra"] != n or counts["filter"] != n or \
                counts["mc"] != n - 1:
            raise AssertionError(f"schedule: launches {counts}")
        path_launches["mesh schedule"] = counts
        print(f"mesh schedule devices={MESH_DEVICES} frames={n} md5_ok="
              f"{3 * n} wall_s={wall:.3f} fps={n / wall:.3f} split_s="
              f"{split1_s:.3f} fps_after_split={n / (wall - split1_s):.3f} "
              f"launches={json.dumps(counts)}", flush=True)
        # K4 on CTB-row bands: the variant stream and the clip
        vdata = port_stream(VARIANTS_STREAM)
        vdec = Decoder(check_md5=True)
        vserial = _host(vdec.decode_stream(vdata))
        if vdec.md5_ok != 3 * VARIANTS_FRAMES:
            raise AssertionError("variants serial decode: md5")
        for name, sdata, sn, swant in (
                ("port_variants_1080p", vdata, VARIANTS_FRAMES, vserial),
                ("1080p_main", data, n, serial)):
            for k in MESH_BANDS:
                mesh = make_mesh(devices=["cuda:0"] * (2 * k))
                if mesh.sp != k:
                    raise AssertionError(f"make_mesh: sp {mesh.sp} != {k}")
                torch.cuda.synchronize()
                device.reset_launches()
                t = time.time()
                frames = dryrun_step(mesh, stream=sdata)
                torch.cuda.synchronize()
                wall = time.time() - t
                counts = device.launches()
                _same_planes(_host(frames), swant, f"sp{k} {name}")
                if counts["filter"] != k * sn or counts["intra"] != sn:
                    raise AssertionError(f"sp{k} {name}: launches {counts}")
                path_launches[f"mesh sp{k} {name}"] = counts
                print(f"mesh sp{k} {name} mesh={mesh.shape} frames={sn} "
                      f"md5_ok={3 * sn} wall_s={wall:.3f} fps="
                      f"{sn / wall:.3f} k4_launches_per_frame="
                      f"{counts['filter'] / sn:.3f} "
                      f"launches={json.dumps(counts)}", flush=True)
        # the reference's form: dryrun_step encodes its own 96x96 I+P+P
        # stream with the port's encoder and asserts every MD5 and plane
        for k in MESH_BANDS:
            mesh = make_mesh(devices=["cuda:0"] * (2 * k))
            torch.cuda.synchronize()
            device.reset_launches()
            t = time.time()
            frames = dryrun_step(mesh)
            torch.cuda.synchronize()
            wall = time.time() - t
            counts = device.launches()
            # three CTB rows of 32: at most three bands run
            if len(frames) != 3 or counts["intra"] != 3 or \
                    counts["filter"] != 3 * min(k, 3):
                raise AssertionError(f"dryrun_step sp{k} (reference form): "
                                     f"{len(frames)} frames, launches "
                                     f"{counts}")
            path_launches[f"mesh sp{k} dryrun_step"] = counts
            print(f"mesh sp{k} dryrun_step(make_mesh(...)) 96x96 frames=3 "
                  f"md5_ok=9 planes=encoder wall_s={wall:.3f} (encode "
                  f"included) launches={json.dumps(counts)}", flush=True)
        # the d5 wire
        decisions = mesh_d5({
            "port_variants_1080p": (vdata, VARIANTS_FRAMES, vserial),
            "1080p_main": (data, n, serial)})
        # dispatches held against a queued device sleep
        _, caps = d5_probe(serial[0])
        no_wait = {what: check_no_wait(sdata, pick, what, dwire)
                   for what, sdata, pick, dwire in (
                       ("1080p_main P frame", data,
                        lambda p: p.slice_type == 1, None),
                       ("port_variants_1080p B frame", vdata,
                        lambda p: p.slice_type == 0, None),
                       ("1080p_main P frame, d5 forced", data,
                        lambda p: p.slice_type == 1, caps))}
        fmt = no_wait["1080p_main P frame, d5 forced"][3]
        if not fmt or fmt[0] != "d5":
            raise AssertionError("no-wait check: the frame was not on d5")
        depth = launch_queue_depth()
        print(f"mesh launch_queue_depth={depth} (launches a stream takes "
              f"behind a stalled kernel before cudaLaunchKernel blocks)",
              flush=True)
    ms, err = time_k4_bands(rng, dev)
    print("mesh k4 bands 1080p (CUDA events, the whole stage) " + " ".join(
        f"{k}_ms={v:.4f}" for k, v in ms.items()) + f" max_abs_err={err}",
        flush=True)
    vcaps = decisions["port_variants_1080p"] or d5_probe(vserial[0])[1]
    d5_ms, raw_ms, nbytes = time_wires(vserial[0], vcaps)
    print(f"mesh d5 wire port_variants_1080p POC 0 with the probe's caps "
          f"{vcaps}: d5_ms={d5_ms:.4f} ({nbytes} bytes) raw_wire_ms="
          f"{raw_ms:.4f} ({sum(p.size for p in vserial[0])} bytes)",
          flush=True)
    print("mesh summary " + json.dumps(dict(
        segments_fps=fps, split_closed_gops_s=split_s, d5_probe={k: bool(v) for k, v in
                                    decisions.items()},
        k4_bands_ms=ms, d5_ms=d5_ms, raw_wire_ms=raw_ms,
        launch_queue_depth=depth,
        no_wait={k: dict(dispatch_ms=v[1] * 1e3, before_sleep_end=v[2],
                         launches=v[4], blocked_in_launch_ms=v[5] * 1e3)
                 for k, v in no_wait.items()})), flush=True)
    return err


KERNELS = (
    ("intra", "K1 intra", "openhevc_tpu_torch/csrc/intra.cu",
     "openhevc_tpu/tpu/intra_pallas.py:341"),
    ("mc", "K2 mc", "openhevc_tpu_torch/csrc/mc.cu",
     "openhevc_tpu/tpu/mc_pallas.py:43"),
    ("paint", "K3 paint", "openhevc_tpu_torch/csrc/paint.cu",
     "openhevc_tpu/tpu/mc_pallas.py:230"),
    ("filter", "K4 deblock+sao", "openhevc_tpu_torch/csrc/filter.cu",
     "openhevc_tpu/tpu/filter_pallas.py:290"),
)
# X3 replaces XLA device code, the reference's accelerator form of the
# SHVC upsample, not a pallas_call
X3_KERNEL = ("upsample", "X3 upsample", "openhevc_tpu_torch/csrc/upsample.cu",
             "openhevc_tpu/tpu/upsample.py:61")
X3_DESIGN = ("one launch a picture: a block per 64x64 EL tile of any plane "
             "(8- or 4-tap path per block); the base window by one TMA load "
             "on an mbarrier (4-byte cp.async where TMA cannot map the "
             "plane), overlapped with the taps' loads; the horizontal sums "
             "kept as int16 in shared memory; the vertical pass by strips "
             "of 4 columns, each one 16-byte store")


class refuse_plain:
    """Inside: every kernel's plain version raises if it is called, so a
    decode on the card can only have gone through the kernels."""

    def __enter__(self):
        from openhevc_tpu_torch.torch_backend import (filter as flt, intra,
                                                      mc as mcm, paint,
                                                      upsample)
        self.plain = [(intra, "intra_plane_plain"), (mcm, "mc_plain"),
                      (paint, "paint_plain_"), (flt, "_filter_plain"),
                      (upsample, "upsample_plane")]
        self.saved = [getattr(m, n) for m, n in self.plain]

        def refuse(*a, **kw):
            raise AssertionError("a plain version ran on the card's main "
                                 "path")
        for m, n in self.plain:
            setattr(m, n, refuse)
        return self

    def __exit__(self, *exc):
        for (m, n), fn in zip(self.plain, self.saved):
            setattr(m, n, fn)


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, ROOT)
    # no cap store, except where the entry-point phase names a temporary one
    os.environ.pop("OPENHEVC_CAP_STORE", None)
    from openhevc_tpu_torch.torch_backend import cuda_lib, device
    from openhevc_tpu_torch import native

    # 1. device
    t = time.time()
    card = card_line()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    print(f"card {card}", flush=True)
    dev = device.pick_device()
    phase("device", t)

    # 2. build
    t = time.time()
    cuda_lib.build()
    cuda_lib.lib()
    phase("build_kernels", t)
    t = time.time()
    native.get_lib()
    phase("build_native", t)

    # 3. kernels against plain versions, small shapes, tolerance 0
    t = time.time()
    rng = np.random.default_rng(SEED)
    errs = {"intra": max(check_k1(rng, dev), check_k1_rejects(rng, dev)),
            "mc": check_k2(rng, dev), "paint": check_k3(rng, dev),
            "filter": check_k4(rng, dev)}
    torch.cuda.synchronize()
    print("kernels " + " ".join(f"{k}={v}" for k, v in errs.items()),
          flush=True)
    fmt_errs = {"intra": check_k1_formats(rng, dev),
                "mc": check_k2_formats(rng, dev),
                "paint": check_k3_formats(rng, dev),
                "filter": check_k4_formats(rng, dev)}
    torch.cuda.synchronize()
    for k, v in fmt_errs.items():
        print(f"kernels_formats {k}={v} variants: "
              + "; ".join(SMALL_VARIANTS[k]), flush=True)
    errs = {k: max(v, fmt_errs[k]) for k, v in errs.items()}
    # X3 from a generator of its own, so the draws of the other phases
    # stay as they were
    x3_err = check_x3(np.random.default_rng(SEED + 3), dev)
    torch.cuda.synchronize()
    print(f"kernels_x3 upsample={x3_err} variants: " + "; ".join(
        X3_VARIANTS), flush=True)
    bad = {k: v for k, v in dict(errs, upsample=x3_err).items() if v != 0}
    if bad:
        raise AssertionError(f"kernels disagree with plain versions: {bad}")
    phase("kernels", t)

    # 4. decode the clip through the kernels only
    with open(STREAM, "rb") as f:
        data = f.read()
    t = time.time()
    split = {}
    with refuse_plain():
        device.reset_launches()
        frames, dec = decode_clip(data, FRAMES, split)
        torch.cuda.synchronize()
        wall = time.time() - t
        counts = device.launches()
    print(f"decode frames={len(frames)} md5_ok={dec.md5_ok} "
          f"md5_fail={dec.md5_fail} wall_s={wall:.3f} "
          f"fps={len(frames) / wall:.3f} launches={json.dumps(counts)}",
          flush=True)
    split["parse_and_rest_s"] = wall - sum(split.values())
    print("decode_split " + " ".join(f"{k}={v:.3f}" for k, v in
                                     split.items()), flush=True)
    if len(frames) != FRAMES or dec.md5_ok != 3 * FRAMES or dec.md5_fail:
        raise AssertionError("decode: frame count or MD5 check failed")
    for f in frames:
        hp = f.host_planes()
        if [p.shape for p in hp] != [(1080, 1920), (540, 960), (540, 960)]:
            raise AssertionError("decode: unexpected plane shapes")
    missing = [k for k, v in counts.items() if v <= 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: "
                             f"{missing}")
    # K1 and K4: one launch a frame; K2: one a P frame; K3: one pass of
    # residuals a frame, one of MC predictions a P frame
    if (counts["intra"] != FRAMES or counts["filter"] != FRAMES
            or counts["mc"] > FRAMES - 1 or counts["paint"] > 2 * FRAMES - 1):
        raise AssertionError(f"launch counts off: {counts}")
    path_launches = {"serial 1080p_main": counts}
    serial_planes = _host(frames)
    phase("decode", t)

    # 5. kernels against plain versions on the clip's inputs, then times
    t = time.time()
    times, clip_errs = time_kernels(data)
    per_stream = {"1080p_main": clip_errs}
    for name in CLIP_CHECK_STREAMS:
        per_stream[name] = check_stream_calls(name)
    torch.cuda.synchronize()
    for name, e in per_stream.items():
        print(f"kernels_clip stream={name} " + " ".join(
            f"{k}={v}" for k, v in e.items()), flush=True)
    clip_errs = {k: max(e[k] for e in per_stream.values())
                 for k in clip_errs}
    print("kernels_clip " + " ".join(f"{k}={v}" for k, v in
                                     clip_errs.items()), flush=True)
    bad = {k: v for k, v in clip_errs.items() if v != 0}
    if bad:
        raise AssertionError(f"kernels disagree with plain versions on the "
                             f"clip's inputs: {bad}")
    prof = profile_frames(data)
    for key, frames_ms in prof.items():
        print(f"profile {key} device_ms " + " ".join(
            f"{f}={'not measured' if v is None else f'{v:.4f}'}"
            for f, v in frames_ms.items()), flush=True)
    prof_streams = {name: profile_frames(bench_stream(name))
                    for name in PROFILE_STREAMS}
    for name, sp in prof_streams.items():
        for key, frames_ms in sp.items():
            print(f"profile stream={name} {key} device_ms " + " ".join(
                f"{f}={'not measured' if v is None else f'{v:.4f}'}"
                for f, v in frames_ms.items()), flush=True)
    rows = []
    for key, name, src, replaces in KERNELS:
        m = times[key]
        row = dict(name=name, route="cuda", source=src, replaces=replaces,
                   launches=counts[key],
                   launches_per_frame=counts[key] / FRAMES,
                   max_abs_err=max(errs[key], clip_errs[key]),
                   ms=m["ms"], plain_ms=m["plain_ms"],
                   library_ms=m["library_ms"], **bound(m))
        print(f"time {name}: ms={m['ms']:.4f} plain_ms={m['plain_ms']:.4f} "
              f"bound_ms={row['bound_ms']:.5f} library_ms={m['library_ms']}",
              flush=True)
        if key == "intra":
            mp = m["p_frame"]
            row["blocks"] = m["blocks"]
            row["depth"] = m["depth"]
            row["p_frame"] = dict(ms=mp["ms"], plain_ms=mp["plain_ms"],
                                  blocks=mp["blocks"], depth=mp["depth"],
                                  **bound(mp))
            print(f"time {name} P frame: ms={mp['ms']:.4f} "
                  f"plain_ms={mp['plain_ms']:.4f} "
                  f"bound_ms={row['p_frame']['bound_ms']:.5f}; depth I "
                  f"{m['depth']} P {mp['depth']}", flush=True)
        if key == "paint":
            row["passes"] = [dict(p, **bound(dict(p, ops=0)))
                             for p in m["passes"]]
            for p in row["passes"]:
                print(f"time {name} pass ({p['groups']} groups, "
                      f"{p['dtype']}): ms={p['ms']:.4f} "
                      f"plain_ms={p['plain_ms']:.4f} "
                      f"bound_ms={p['bound_ms']:.5f} "
                      f"library_ms={p['library_ms']:.4f}", flush=True)
        row["profiler_device_ms"] = prof[key]
        row["profiler_device_ms_streams"] = {
            name: sp[key] for name, sp in prof_streams.items()}
        row["variants"] = SMALL_VARIANTS[key] + [
            f"the I and first P frames' calls of {name}"
            for name in per_stream]
        rows.append(row)
    phase("timing", t)

    # 6. the pipelined decoder: the bench streams (the SHVC stream's base
    # layer), each decoded twice through the kernels only, one upload a
    # frame; the dispatch of a P frame without a host wait; the device's
    # idle share
    t = time.time()
    fps = {}
    with refuse_plain():
        for name in SYNC_STREAMS:
            poc = check_no_sync(data if name == "1080p_main"
                                else bench_stream(name))
            print(f"pipeline sync_debug=error over the dispatch of "
                  f"{name}'s P frame POC {poc}: no host wait", flush=True)
        for name, n_frames, shapes in PIPELINE_STREAMS:
            sdata = data if name == "1080p_main" else bench_stream(name)
            for run in range(PIPELINE_RUNS):
                pwall, pcounts, h2d, pdec, busy = decode_pipelined(
                    sdata, n_frames, shapes)
                fps.setdefault(name, []).append(n_frames / pwall)
                print(f"pipeline {name} run={run + 1} frames={n_frames} "
                      f"md5_ok={pdec.md5_ok} md5_fail={pdec.md5_fail} "
                      f"wall_s={pwall:.3f} fps={n_frames / pwall:.3f} "
                      f"launches={json.dumps(pcounts)} "
                      f"h2d_per_frame={h2d / n_frames:.3f} " + " ".join(
                          f"{k}={v:.3f}" for k, v in busy.items()),
                      flush=True)
                if h2d != n_frames or pcounts["intra"] != n_frames or \
                        pcounts["filter"] != n_frames or \
                        min(pcounts.values()) <= 0:
                    raise AssertionError(
                        f"pipeline {name}: {h2d} uploads and launches "
                        f"{pcounts} for {n_frames} frames")
                path_launches[f"pipeline {name} run {run + 1}"] = pcounts
        print("pipeline 1080p_main host split (serial decode) " + " ".join(
            f"{k}={split[k]:.3f} (PR 6: {v})" for k, v in PR6_SPLIT.items())
            + f"; serial fps={FRAMES / wall:.3f}, pipelined fps="
            + " / ".join(f"{v:.3f}" for v in fps["1080p_main"]), flush=True)
        idle = idle_share(data)
    print("pipeline 1080p_main steady window " + " ".join(
        f"{k}={v:.4f}" if isinstance(v, float) else f"{k}={v}"
        for k, v in idle.items()), flush=True)
    phase("pipeline", t)

    # 7. two-layer SHVC through ShvcDecoder(), twice; X3 held and timed
    t = time.time()
    sdata = bench_stream("shvc_4k60")
    x3_main = None
    with refuse_plain():
        for run in range(SHVC_RUNS):
            swall, scounts, x3c, x3n, h2d, sdec, outs = decode_shvc(sdata)
            n = 2 * SHVC_PICTURES
            print(f"shvc shvc_4k60 run={run + 1} frames={n} (both layers) "
                  f"md5_ok={sdec.md5_ok} md5_fail={sdec.md5_fail} "
                  f"wall_s={swall:.3f} fps_el={SHVC_PICTURES / swall:.3f} "
                  f"launches={json.dumps(scounts)} x3_calls={x3c} "
                  f"x3_launches={x3n} h2d={h2d}", flush=True)
            if min(scounts.values()) <= 0:
                raise AssertionError(f"SHVC: launches {scounts}")
            path_launches[f"shvc shvc_4k60 run {run + 1}"] = dict(
                scounts, upsample=x3n)
            if x3_main is None:
                x3_main = (x3n, x3c)
    x3 = time_x3(list(outs[0][0].planes))
    print(f"x3 upsample 1920x1080 -> 3840x2160 4:2:0: max_abs_err="
          f"{x3['max_abs_err']} (kernel against the gather form and the "
          f"NumPy model) library_err={x3['library_err']} "
          f"ms={x3['ms']:.4f} plain_ms={x3['plain_ms']:.4f} "
          f"library_ms={x3['library_ms']:.4f} (upsample_plane_mm) "
          f"device_ms={x3['device_ms']:.4f} (torch.profiler, a picture, "
          f"back to back: the {x3['base_bytes']} bytes of base planes fit "
          f"the 50 MB L2, partly resident behind the last picture's writes) "
          f"achieved_gbps={x3['gbps']:.1f} "
          f"bound_share={x3['bound_share']:.3f} "
          f"device_cold_ms={x3['device_cold_ms']:.4f} (the base planes not "
          f"in L2: a 128 MB read before each picture) "
          f"cold_gbps={x3['cold_gbps']:.1f} "
          f"cold_bound_share={x3['cold_bound_share']:.3f} "
          f"bound_ms={x3['bound_ms']:.5f} ({x3['bound_by']}, "
          f"{x3['bytes']} bytes, {x3['ops']} operations) "
          f"launches={x3_main[0]} ({x3_main[1]} pictures, 1 a picture) "
          f"card='{card}'", flush=True)
    if x3["max_abs_err"] != 0 or x3["library_err"] != 0:
        raise AssertionError("X3 disagrees with its plain version, the "
                             "NumPy model or the band-matrix form")
    phase("shvc", t)

    # 8. the variants: K4 with per-CTB map grids, K1-K4 on the variant
    # stream's I, P and B frames, that stream twice through the pipeline
    # and the encrypted stream twice through Decoder(encrypt_params=15)
    t = time.time()
    var_errs = run_variants(rng, dev, path_launches)
    bad = {k: v for k, v in var_errs.items() if v != 0}
    if bad:
        raise AssertionError(f"kernels disagree with plain versions on the "
                             f"variants: {bad}")
    phase("variants", t)

    # 9. the entry points: the API (the clip, and the SHVC stream's layer
    # chain), the CLI on annex-B and MP4, the C shim's driver
    t = time.time()
    entry_points(data, path_launches)
    phase("entry_points", t)

    # 10. multi-device decode on the card: closed-GOP segments from two
    # threads, an open GOP over a device schedule, K4 on CTB-row bands;
    # the d5 wire; dispatches held against a queued device sleep
    t = time.time()
    var_errs["filter"] = max(var_errs["filter"], run_mesh(
        rng, dev, data, serial_planes, path_launches))
    if var_errs["filter"] != 0:
        raise AssertionError("banded K4 disagrees with the plain version")
    phase("mesh", t)
    key, name, src, replaces = X3_KERNEL
    rows.append(dict(
        name=name, route="cuda", source=src, replaces=replaces,
        launches=x3_main[0], launches_per_picture=x3_main[0] / x3_main[1],
        max_abs_err=max(x3_err, x3["max_abs_err"], x3["library_err"]),
        ms=x3["ms"], plain_ms=x3["plain_ms"], library_ms=x3["library_ms"],
        profiler_device_ms=x3["device_ms"],
        profiler_device_cold_ms=x3["device_cold_ms"],
        achieved_gbps=x3["gbps"], bound_share=x3["bound_share"],
        bound_ms=x3["bound_ms"], bound_by=x3["bound_by"],
        design=X3_DESIGN,
        variants=X3_VARIANTS + [
            "one 1920x1080 to 3840x2160 4:2:0 picture of shvc_4k60, also "
            "against the NumPy model and upsample_plane_mm"]))
    for key, row in zip([k[0] for k in KERNELS] + [key], rows):
        row["launches_by_path"] = {p: c.get(key, 0)
                                   for p, c in path_launches.items()}
        if key == X3_KERNEL[0]:
            continue
        row["max_abs_err"] = max(row["max_abs_err"], var_errs[key])
        row["variants"] += VARIANT_CALLS[key]
        if key == "filter":
            row["variants"].append(
                "on CTB-row bands (k = 2, 4) of a 1080p frame, one launch "
                "a band, against the unbanded plain version")
    phase("total", T0)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
