#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``openhevc_tpu_torch`` only (nothing of JAX or ``openhevc_tpu``):

1. device: torch / CUDA versions, the card's name and power limit;
2. build: the CUDA kernels (nvcc, sm_90a) and the native C++ front-end;
3. kernels: K1-K4 against their plain PyTorch versions on the card, on
   seeded inputs at small shapes, tolerance 0 (integer pipeline): K1 on
   random quadtrees in valid decode order, plus a forward dependency and
   an overlap that it must reject (raise, not hang); K2 on one pass of
   every tile size and plane, depths 8 and 10; K3 on mixed passes; K4 on
   three-plane frames (one not a multiple of the CTB), depths 8 and 10;
4. decode: the committed 1080p Main clip through ``Decoder(check_md5=True)``
   (the card by default); every decoded-picture-hash SEI must match, every
   kernel must have launched, K1 and K4 once a frame, K2 at most once and
   K3 at most twice;
5. timing: each kernel held again against its plain version, tolerance 0,
   on the clip's own inputs (the I frame's and the first P frame's calls),
   then timed there (CUDA events) beside its plain version, its bound and,
   where one exists, a single PyTorch call that computes the same function:
   K1 on the I and the P frame with the depth of its wavefront, K3 per
   pass; torch.profiler's device time of every kernel where it has one;
6. the ``kernels`` JSON line, the card line, and the final status line.

Any failure raises and the script exits non-zero without a status line.
"""

import json
import os
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

def k1_blocks(rng, H, W, ctb, min_log2):
    """A random quadtree of blocks (2^min_log2 to ctb) in z-order over the
    CTBs of an (H, W) plane in raster order, split where a block would
    cross the picture's edge.  -> [(x, y, n)] in decode order."""
    out = []

    def split(x, y, n):
        if x >= W or y >= H:
            return
        inside = x + n <= W and y + n <= H
        if n > 1 << min_log2 and (not inside or rng.random() < 0.55):
            h = n // 2
            for dy in (0, h):
                for dx in (0, h):
                    split(x + dx, y + dy, h)
        else:
            out.append((x, y, n))
    for cy in range(0, H, ctb):
        for cx in range(0, W, ctb):
            split(cx, cy, ctb)
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


def k1_cases(rng, H=136, W=200):
    """Luma (CTB 32, blocks 4-32) and 4:2:0 chroma (CTB 16, blocks 4-16)
    planes in valid decode order, with smooth planes (so the strong filter
    fires) and small residuals.  -> [(c_idx, H, W, plane, resid, blocks,
    flags, later)]."""
    cases = []
    for c_idx, (h, w), ctb in ((0, (H, W), 32), (1, (H // 2, W // 2), 16)):
        blocks = k1_blocks(rng, h, w, ctb, 2)
        flags, later = k1_flags(blocks, h, w)
        yy, xx = np.mgrid[0:h, 0:w]
        plane = (60 + yy + xx // 2 + rng.integers(-2, 3, (h, w))).clip(
            0, 255).astype(np.int32)
        resid = rng.integers(-3, 4, (h, w)).astype(np.int32)
        resid[rng.random((h, w)) < 0.02] = 90
        cases.append((c_idx, h, w, plane, resid, blocks, flags, later))
    return cases


def _k1_run(dev, cases, metas, strong):
    import torch
    from openhevc_tpu_torch.torch_backend import intra
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    args = ([t(c[3]) for c in cases], [t(c[4]) for c in cases],
            [t(m.reshape(-1, 128, 8)) for m in metas], [c[0] for c in cases])
    got = intra.intra_planes(*args, 8, strong, False)
    ref = [intra.intra_plane_plain(p, r, m, c, 8, strong, False)
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


def check_k1_rejects(rng, dev):
    """Metadata the wavefront cannot schedule must raise, not hang: a flag
    on a neighbour that a later block writes, and two blocks writing one
    unit.  intra_schedule (the plain rule) must reject both too.  -> 0."""
    from openhevc_tpu_torch.torch_backend import intra
    cases = k1_cases(rng)
    c_idx, H, W, plane, resid, blocks, flags, later = cases[0]
    fwd = list(flags)
    b = next(i for i, fl in enumerate(later) if fl)
    fwd[b] |= later[b]
    over = blocks + [blocks[len(blocks) // 2]]
    for name, meta in (("forward dependency", k1_meta(rng, blocks, fwd)),
                       ("overlap", k1_meta(rng, over, flags + [0]))):
        for rule, run in (
                ("intra_schedule",
                 lambda: intra.intra_schedule(meta, H, W, c_idx)),
                ("kernel", lambda: _k1_run(dev, cases[:1], [meta], 0))):
            try:
                run()
            except (RuntimeError, ValueError):
                continue
            raise AssertionError(f"K1 {rule}: {name} was not rejected")
    return 0


def k2_pass(rng, dev, bd, n=96, H=96, W=128):
    """One mixed pass: the six tile sizes on a luma plane and two 4:2:0
    chroma planes, the chroma groups sharing the luma work vectors as
    frame_step's do; a quarter of the motion vectors point far outside
    the picture.  -> [McGroup]."""
    import torch
    from openhevc_tpu_torch.torch_backend.mc import McGroup
    from openhevc_tpu_torch.torch_backend.plan_compile import TILE_SIZES
    t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)  # noqa
    refs = [t(rng.integers(0, 1 << bd, (3, h, w)))
            for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2))]
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
            s_ = min(c, 1)
            groups.append(McGroup(refs[c], *vecs, w >> s_, h >> s_, c == 0,
                                  bd, 1, 1, s_, s_))
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


def k3_pass(rng, dev, dt, H=200, W=264, n=40):
    """One mixed pass: the six tile shapes on two planes, disjoint tiles at
    random places (some crossing the planes' right and bottom edges, some
    invalid).  -> (groups, planes)."""
    import torch
    planes = [torch.as_tensor(rng.integers(-99, 99, s), device=dev).to(dt)
              for s in ((H, W), (H // 2 + 3, W // 2 + 5))]
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
            tiles = torch.as_tensor(rng.integers(-3000, 3000,
                                                 (len(pick), h, w)),
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


def k4_frame(rng, dev, H, W, bd, ctb=64):
    """A 4:2:0 frame of (H, W) luma: three planes, their deblocking grids
    built from random maps over the grids' padded geometry (so edges past
    the picture carry nonzero tc), random SAO grids and restore masks."""
    import torch
    from openhevc_tpu_torch.torch_backend import filter as flt
    t = lambda a: torch.as_tensor(np.asarray(a, np.int32), device=dev)  # noqa
    Hp, Wp = H + (-H % 16), W + (-W % 16)
    vbs = t(rng.integers(0, 3, (Hp // 4, Wp // 8)))
    hbs = t(rng.integers(0, 3, (Hp // 8, Wp // 4)))
    qp = t(rng.integers(15, 48, (Hp // 8, Wp // 8)))
    nfm = t(rng.random((Hp // 4, Wp // 4)) < 0.05)
    qpc = t([29, 30, 31, 32, 33, 33, 34, 34, 35, 35, 36, 36, 37, 37])
    planes, grids, sao, restores = [], [], [], []
    for c in range(3):
        h, w = (H, W) if c == 0 else (H // 2, W // 2)
        cs = ctb >> min(c, 1)
        hi = 1 << bd
        base = rng.integers(hi // 4, 3 * hi // 4, (h // 8 + 1, w // 8 + 1))
        base = base.repeat(8, 0).repeat(8, 1)[:h, :w]
        planes.append(t(base + rng.integers(-3, 4, (h, w))))
        if c == 0:
            grids.append(flt.build_luma_grids(vbs, hbs, qp, 2, -2, nfm, bd,
                                              Hp, Wp))
        else:
            grids.append(flt.build_chroma_grids(
                vbs, hbs, qp, c, 0, 0, nfm, qpc, bd, Hp // 2, Wp // 2, 2, 2,
                True))
        grid = (-(-h // cs), -(-w // cs))
        om = rng.integers(-7, 8, grid + (5,))
        om[..., 0] = 0
        sao.append((t(rng.integers(0, 3, grid)), t(rng.integers(0, 32, grid)),
                    t(rng.integers(0, 4, grid)), t(om)))
        restores.append(t(rng.random((h, w)) < 0.02) if c != 1 else None)
    return planes, grids, sao, restores


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


# ---------------------------------------------------------------------------
# phases 4-5: the clip, and the kernels timed on its inputs
# ---------------------------------------------------------------------------

def decode_clip(data, n_frames, split=None):
    """Decode the first n_frames pictures; returns (frames, decoder).

    split: optional dict that receives host seconds spent in the backend's
    plan preparation, in enqueueing the frame's device work, and in the
    output fetch + MD5 check (which waits for the device); the rest of
    the wall time is the front-end's parse."""
    from openhevc_tpu_torch.decoder.frontend import Decoder
    dec = Decoder(check_md5=True)
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


def decode_checked(data, n_frames, split=None):
    """decode_clip, raising unless n_frames pictures came out with all
    three plane MD5s of each matching the stream's SEI."""
    frames, dec = decode_clip(data, n_frames, split)
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
            errs["intra"] = max(errs["intra"], _max_diff(
                intra.intra_planes(*a, **kw), ref))
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


def profile_frames(data):
    """Device time of K1-K4 from torch.profiler: the decode of the I
    frame alone, and of the I and first P frames (the P frame is the
    difference).  Each decode is checked like the main path's; only the
    profiler's own calls may fail softly.  -> ({kernel: {"i_frame": ms,
    "p_frame": ms}}, None), a value None where the profiler showed no
    device time for the kernel; or (None, why) where the profiler itself
    failed."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    names = {"intra": ("owner_kernel", "wavefront_kernel"),
             "mc": ("mc_pass_kernel",),
             "paint": ("paint_pass_kernel",),
             "filter": ("filter_frame_kernel",)}
    tot = []
    for n in (1, 2):
        try:
            prof = profile(activities=[ProfilerActivity.CPU,
                                       ProfilerActivity.CUDA])
            prof.start()
        except Exception as e:      # no profiler: a reading, not a check
            return None, f"{type(e).__name__}: {e}"
        try:
            decode_checked(data, n)
            torch.cuda.synchronize()
        finally:
            stopped = _profiler_call(prof.stop)
        if stopped is not None:
            return None, stopped
        t = dict.fromkeys(names, 0.0)
        events = []
        why = _profiler_call(lambda: events.extend(prof.key_averages()))
        if why is not None:
            return None, why
        for e in events:
            us = (getattr(e, "self_device_time_total", 0) or
                  getattr(e, "self_cuda_time_total", 0))
            for k, pats in names.items():
                if any(pat in e.key for pat in pats):
                    t[k] += us / 1e3
        tot.append(t)
    return {k: {"i_frame": tot[0][k] or None,
                "p_frame": (tot[1][k] - tot[0][k]) if tot[1][k] else None}
            for k in names}, None


def _profiler_call(fn):
    """Run one of the profiler's own calls -> None, or why it failed."""
    try:
        fn()
    except Exception as e:          # no profiler: a reading, not a check
        return f"{type(e).__name__}: {e}"
    return None


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


def main():
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    sys.path.insert(0, ROOT)
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
    bad = {k: v for k, v in errs.items() if v != 0}
    if bad:
        raise AssertionError(f"kernels disagree with plain versions: {bad}")
    phase("kernels", t)

    # 4. decode the clip through the kernels only
    with open(STREAM, "rb") as f:
        data = f.read()
    from openhevc_tpu_torch.torch_backend import (filter as flt, intra,
                                                  mc as mcm, paint)
    plain = [(intra, "intra_plane_plain"), (mcm, "mc_plain"),
             (paint, "paint_plain_"), (flt, "_filter_plain")]
    saved = [getattr(m, n) for m, n in plain]

    def refuse(*a, **kw):
        raise AssertionError("a plain version ran on the card's main path")
    for m, n in plain:
        setattr(m, n, refuse)
    t = time.time()
    split = {}
    device.reset_launches()
    frames, dec = decode_clip(data, FRAMES, split)
    torch.cuda.synchronize()
    wall = time.time() - t
    counts = device.launches()
    for (m, n), fn in zip(plain, saved):
        setattr(m, n, fn)
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
    phase("decode", t)

    # 5. kernels against plain versions on the clip's inputs, then times
    t = time.time()
    times, clip_errs = time_kernels(data)
    print("kernels_clip " + " ".join(f"{k}={v}" for k, v in
                                     clip_errs.items()), flush=True)
    bad = {k: v for k, v in clip_errs.items() if v != 0}
    if bad:
        raise AssertionError(f"kernels disagree with plain versions on the "
                             f"clip's inputs: {bad}")
    prof, why = profile_frames(data)
    if prof is None:
        print(f"profile device_ms not measured (profiler "
              f"failed: {why})", flush=True)
        prof = {}
    for key, frames_ms in prof.items():
        print(f"profile {key} device_ms " + " ".join(
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
        if key in prof:
            row["profiler_device_ms"] = prof[key]
        rows.append(row)
    phase("timing", t)
    phase("total", T0)
    print(json.dumps({"kernels": rows}), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
