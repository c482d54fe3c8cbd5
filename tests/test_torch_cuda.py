"""The port on a card: CUDA kernels against their plain versions, and
encoder-made streams decoded through the kernels: 8-bit 4:2:0, 4:2:2,
4:4:4 with cross-component prediction, depths 12 and 14, two-layer SHVC,
weighted prediction, scaling lists, PCM, multi-slice pictures with
per-slice deblocking offsets, long-term references and plans from the
Python front-end; the committed encrypted stream; and the entry points
users call (the API, the CLI and the C shim's driver) on a stream with
those variants at once.

Marked ``cuda``; skips where there is no card.  The machine with the card
has no JAX, and tests/conftest.py imports it, so run this file there with
``python -m pytest tests/test_torch_cuda.py -m cuda --noconftest``.  The
streams come from the port's own encoder (``openhevc_tpu_torch.encoder``):
nothing of JAX or ``openhevc_tpu`` is imported here.
"""

import os
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

import chip_smoke
from openhevc_tpu_torch.encoder import Encoder, EncoderConfig
from util_e2e import make_source, assert_frames_equal   # tests/ dir


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["k1", "k1_rejects", "k2", "k3", "k4",
                                    "k1_formats", "k2_formats",
                                    "k3_formats", "k4_formats", "x3"])
def test_kernel_matches_plain_on_card(kernel):
    """K1-K4 on seeded inputs at small shapes, tolerance 0 (the checks of
    chip_smoke.py's kernel phase): K1 on quadtrees in valid decode order,
    and its forward-dependency and overlap cases, which must raise; K2 on
    one pass of every tile size and plane, depths 8 and 10; K3 on a mixed
    pass of every tile shape, int32 and int16; K4 on three-plane frames,
    sizes that are not multiples of the CTB among them, depths 8 and
    10.  The *_formats checks: K1 at depths 10-14, on 4:2:2 chroma planes
    and with c444; K2 for each chroma subsampling at depths 8-14; K3 on
    4:2:2 and 4:4:4 plane shapes; K4 at depths 12 and 14 and with 4:2:2
    and 4:4:4 chroma grids.  x3: X3's kernel against its gather form on
    whole frames at depths 8-14, 4:2:0, 4:2:2 and 4:4:4, ratios 2x, 1.5x
    and an arbitrary one, with extreme samples."""
    _need_card()
    rng = np.random.default_rng(chip_smoke.SEED)
    check = getattr(chip_smoke, f"check_{kernel}")
    assert check(rng, torch.device("cuda")) == 0


CASES = [
    ("slice_shape", EncoderConfig(width=192, height=128, qp=32, log2_ctb=6,
                                  wpp=True, sao=True, rng_seed=36), "IPPP"),
    ("inter_b_sao", EncoderConfig(width=128, height=64, qp=31, sao=True,
                                  rng_seed=36), "IPBB"),
    ("amp", EncoderConfig(width=128, height=128, qp=30, amp=True, p_amp=0.8,
                          p_skip=0.1, log2_ctb=6, rng_seed=42), "IPP"),
    ("intra_qp0", EncoderConfig(width=128, height=64, qp=0, rng_seed=33),
     "I"),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,cfg,pattern", CASES, ids=[c[0] for c in CASES])
def test_port_decode_on_card(name, cfg, pattern):
    """Whole decodes through the kernels, on the card by default: the
    encoder's reconstruction and every SEI MD5 must match, every kernel
    the frames need ran, K3 painted at most two passes a frame, K2 ran
    at most once a frame that predicts from references, and K4 exactly
    once a frame."""
    _need_card()
    from openhevc_tpu_torch.decoder.frontend import Decoder
    from openhevc_tpu_torch.torch_backend import device
    rng = np.random.default_rng(len(name))
    enc = Encoder(cfg)
    stream = b"".join(enc.parameter_set_nals())
    base = make_source(rng, cfg.width, cfg.height)
    recons = []
    for i, st in enumerate(pattern):
        src = [np.roll(np.roll(base[0], i, 0), 2 * i, 1),
               np.roll(base[1], i, 0), np.roll(base[2], i, 0)]
        nal, recon, _ = enc.encode_frame(src, st)
        stream += nal
        recons.append([np.asarray(p).copy() for p in recon])
    device.reset_launches()
    dec = Decoder(check_md5=True)
    frames = dec.decode_stream(stream)
    counts = device.launches()
    mine = [[np.asarray(p).astype(np.int32) for p in f.host_planes()]
            for f in frames]
    assert dec.md5_ok == 3 * len(pattern) and dec.md5_fail == 0
    assert_frames_equal(mine, recons, name)
    assert counts["intra"] > 0 and counts["paint"] > 0 and \
        counts["filter"] > 0
    assert counts["paint"] <= 2 * len(pattern)
    assert counts["filter"] == len(pattern)
    inter = sum(st in "PB" for st in pattern)
    assert counts["mc"] <= inter
    if inter:
        assert counts["mc"] > 0


@pytest.mark.cuda
def test_pipelined_matches_serial_on_card():
    """An encoder-made IPPBP stream (TMVP, SAO) through PipelinedDecoder()
    and through Decoder(), both on the card by default: the same frames
    in the same order, plane for plane, tolerance 0, every SEI MD5
    passing, with one plan upload a frame in the pipeline."""
    _need_card()
    from openhevc_tpu_torch.decoder.frontend import Decoder
    from openhevc_tpu_torch.runtime import PipelinedDecoder
    from openhevc_tpu_torch.torch_backend import device
    cfg = EncoderConfig(width=192, height=128, qp=30, log2_ctb=6, sao=True,
                        temporal_mvp=True, rng_seed=37)
    rng = np.random.default_rng(37)
    enc = Encoder(cfg)
    stream = b"".join(enc.parameter_set_nals())
    base = make_source(rng, cfg.width, cfg.height)
    for i, st in enumerate("IPPBP"):
        src = [np.roll(np.roll(base[0], i, 0), 2 * i, 1),
               np.roll(base[1], i, 0), np.roll(base[2], i, 0)]
        stream += enc.encode_frame(src, st)[0]
    serial = Decoder(check_md5=True)
    want = [[np.asarray(p) for p in f.host_planes()]
            for f in serial.decode_stream(stream)]
    dec = PipelinedDecoder(check_md5=True)
    device.reset_launches()
    got = [[np.asarray(p) for p in f.host_planes()]
           for f in dec.frames(stream)]
    assert device.h2d_copies() == 5
    assert dec.md5_ok == 15 and dec.md5_fail == 0 and serial.md5_ok == 15
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a, b)


def _noise_stream(cfg, pattern, seed):
    """An encoder-made stream of uniform planes at the configuration's
    chroma format and depth (the RExt tests' source), and its
    reconstruction."""
    rng = np.random.default_rng(seed)
    enc = Encoder(cfg)
    stream = b"".join(enc.parameter_set_nals())
    hs = 1 if cfg.chroma_format in (1, 2) else 0
    vs = 1 if cfg.chroma_format == 1 else 0
    h, w, hi = cfg.height, cfg.width, 1 << cfg.bit_depth
    base = [rng.integers(0, hi, s).astype(np.int32)
            for s in ((h, w), (h >> vs, w >> hs), (h >> vs, w >> hs))]
    recons = []
    for i, st in enumerate(pattern):
        nal, recon, _ = enc.encode_frame([np.roll(p, i, 0) for p in base],
                                         st)
        stream += nal
        recons.append([np.asarray(p).copy() for p in recon])
    return stream, recons


FORMAT_CASES = [
    ("rext_422_sao", EncoderConfig(width=96, height=64, qp=30, rng_seed=17,
                                   chroma_format=2, sao=True), "IPPB"),
    ("rext_444_cross_component", EncoderConfig(
        width=96, height=64, qp=30, rng_seed=7, chroma_format=3,
        cross_component=True, transform_skip=True, implicit_rdpcm=True),
     "IPP"),
    ("main12", EncoderConfig(width=96, height=64, qp=30, bit_depth=12,
                             sao=True, rng_seed=58), "IPB"),
    ("main14", EncoderConfig(width=96, height=64, qp=33, bit_depth=14,
                             sao=True, rng_seed=57), "IPP"),
]

VARIANT_CASES = [
    ("weighted_pred", EncoderConfig(width=96, height=64, qp=30,
                                    weighted_pred=True, rng_seed=39),
     "IPB", True),
    ("weighted_pred_main14", EncoderConfig(width=96, height=64, qp=33,
                                           bit_depth=14, weighted_pred=True,
                                           rng_seed=45), "IPB", True),
    ("scaling_custom", EncoderConfig(width=96, height=64, qp=30,
                                     scaling_lists="custom",
                                     p_intra_in_inter=0.2, rng_seed=404),
     "IPB", True),
    ("pcm_lf_disabled", EncoderConfig(width=96, height=64, qp=30, p_pcm=0.5,
                                      p_intra_in_inter=0.3,
                                      pcm_loop_filter_disabled=True,
                                      rng_seed=909), "IPBP", True),
    ("slice_filter_variants", EncoderConfig(
        width=128, height=96, qp=30, slices=3, sao=True, across_slices=False,
        slice_filter_variants=True, rng_seed=13), "IPP", True),
    ("long_term_tmvp", EncoderConfig(width=96, height=64, qp=30,
                                     long_term=True, max_refs=2,
                                     temporal_mvp=True,
                                     p_intra_in_inter=0.1, rng_seed=13),
     "IPPBPP", True),
    ("python_plans_all_variants", EncoderConfig(
        width=128, height=96, qp=30, weighted_pred=True,
        scaling_lists="custom", p_pcm=0.3, p_intra_in_inter=0.3,
        pcm_loop_filter_disabled=True, slices=3, slice_filter_variants=True,
        temporal_mvp=True, rng_seed=71), "IPBP", False),
    ("python_plans_cross_component", EncoderConfig(
        width=96, height=64, qp=30, rng_seed=7, chroma_format=3,
        cross_component=True, transform_skip=True, implicit_rdpcm=True),
     "IPP", False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("name,cfg,pattern,use_native", VARIANT_CASES,
                         ids=[c[0] for c in VARIANT_CASES])
def test_port_variants_on_card(name, cfg, pattern, use_native):
    """Weighted prediction (depths 8 and 14), scaling lists, PCM with the
    loop filter off over it, per-slice deblocking offsets, long-term
    references, and all of them at once in plans from the Python
    front-end (and, from it too, cross-component alpha maps), through the kernels on the card with the plain versions
    refused: the encoder's reconstruction and every SEI MD5 must match,
    every kernel ran, K4 once a frame and K1 at most once (a frame
    without intra blocks runs none)."""
    _need_card()
    from openhevc_tpu_torch.decoder.frontend import Decoder
    from openhevc_tpu_torch.torch_backend import device
    stream, recons = _noise_stream(cfg, pattern, len(name))
    with chip_smoke.refuse_plain():
        device.reset_launches()
        dec = Decoder(check_md5=True, use_native=use_native)
        frames = dec.decode_stream(stream)
        mine = [[np.asarray(p).astype(np.int32) for p in f.host_planes()]
                for f in frames]
    counts = device.launches()
    assert dec.md5_ok == 3 * len(pattern) and dec.md5_fail == 0
    assert_frames_equal(mine, recons, name)
    assert min(counts.values()) > 0
    assert counts["filter"] == len(pattern)
    assert counts["intra"] <= len(pattern)


@pytest.mark.cuda
def test_committed_encrypted_stream_on_card():
    """streams/port_encrypted_480p.265 (every encryption class) through
    Decoder(encrypt_params=15) on the card with the plain versions
    refused: every MD5 of its 8 frames, one upload a frame.  The encoder
    needs the cryptography package, which this machine may lack, so the
    committed stream stands in for an encoder-made one."""
    _need_card()
    with chip_smoke.refuse_plain():
        wall, counts, h2d, dec = chip_smoke.decode_encrypted(
            chip_smoke.port_stream(chip_smoke.ENCRYPTED_STREAM))
    assert dec.md5_ok == 24 and dec.md5_fail == 0
    assert h2d == 8 and min(counts.values()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("name,cfg,pattern", FORMAT_CASES,
                         ids=[c[0] for c in FORMAT_CASES])
def test_port_formats_on_card(name, cfg, pattern):
    """RExt chroma formats (4:4:4 with cross-component prediction) and
    depths 12 and 14 through the kernels on the card: the encoder's
    reconstruction and every SEI MD5 must match, every kernel ran."""
    _need_card()
    from openhevc_tpu_torch.decoder.frontend import Decoder
    from openhevc_tpu_torch.torch_backend import device
    stream, recons = _noise_stream(cfg, pattern, len(name))
    device.reset_launches()
    dec = Decoder(check_md5=True)
    frames = dec.decode_stream(stream)
    counts = device.launches()
    mine = [[np.asarray(p).astype(np.int32) for p in f.host_planes()]
            for f in frames]
    assert dec.md5_ok == 3 * len(pattern) and dec.md5_fail == 0
    assert_frames_equal(mine, recons, name)
    assert min(counts.values()) > 0
    assert counts["filter"] == len(pattern)


@pytest.mark.cuda
def test_shvc_on_card():
    """A two-layer 2x spatial SHVC stream (IPBP, TMVP) through
    ShvcDecoder(): both layers on the card, the inter-layer upsample on
    the device; both layers equal the encoder's reconstruction, every MD5
    of both layers passes, every kernel ran, X3's kernel once (one launch
    for the three planes) for every EL picture that predicts from the
    base layer."""
    _need_card()
    from openhevc_tpu_torch.encoder.shvc import ShvcEncoder
    from openhevc_tpu_torch.decoder.shvc import ShvcDecoder
    from openhevc_tpu_torch.torch_backend import device
    cfg_bl = EncoderConfig(width=48, height=32, qp=30, rng_seed=29,
                           temporal_mvp=True)
    cfg_el = EncoderConfig(width=96, height=64, qp=30, rng_seed=31,
                           temporal_mvp=True)
    enc = ShvcEncoder(cfg_bl, cfg_el)
    stream = b"".join(enc.parameter_set_nals())
    rng = np.random.default_rng(42)
    src_bl = make_source(rng, 48, 32)
    src_el = make_source(rng, 96, 64)
    want = [[], []]
    for i, t in enumerate("IPBP"):
        au, rb, re = enc.encode_frame([np.roll(p, i, 0) for p in src_bl],
                                      [np.roll(p, i, 1) for p in src_el], t)
        stream += au
        want[0].append([np.asarray(p).astype(np.int32) for p in rb])
        want[1].append([np.asarray(p).astype(np.int32) for p in re])
    device.reset_launches()
    dec = ShvcDecoder(check_md5=True)
    outs = dec.decode_stream(stream)
    assert dec.md5_ok == 24 and dec.md5_fail == 0
    assert min(device.launches().values()) > 0
    assert device.x3_launches() == 3     # the three P/B EL pictures
    for lid in (0, 1):
        assert outs[lid][0].planes[0].device.type == "cuda"
        mine = [[np.asarray(p).astype(np.int32) for p in f.host_planes()]
                for f in outs[lid]]
        assert_frames_equal(mine, want[lid], f"layer {lid}")


ENTRY_CFG = EncoderConfig(
    width=128, height=96, qp=30, weighted_pred=True, scaling_lists="custom",
    p_pcm=0.3, p_intra_in_inter=0.3, pcm_loop_filter_disabled=True,
    slices=3, slice_filter_variants=True, temporal_mvp=True, rng_seed=73)
ENTRY_PATTERN = "IPBP"


@pytest.fixture(scope="module")
def entry_stream():
    """The variants of the port's main path at once (weighted prediction,
    scaling lists, PCM with the loop filter off over it, per-slice
    deblocking offsets, TMVP) -> (stream, the encoder's YUV bytes)."""
    _need_card()
    stream, recons = _noise_stream(ENTRY_CFG, ENTRY_PATTERN, 73)
    yuv = b"".join(np.asarray(p).astype(np.uint8).tobytes()
                   for f in recons for p in f)
    return stream, yuv


def _check_entry_counts(counts, per_frame):
    n = len(ENTRY_PATTERN)
    assert min(counts.values()) > 0 and counts["filter"] == n
    assert counts["intra"] <= n and counts["mc"] <= n - 1
    assert len(per_frame) == n and per_frame[0] >= 1
    assert per_frame[1:] == [1] * (n - 1)     # one upload a frame


@pytest.mark.cuda
def test_api_on_card(entry_stream):
    """OpenHevcDecoder() (the card by default), one access unit a call,
    the plain versions refused: the encoder's bytes, every MD5 passing,
    every kernel launched, one upload a frame."""
    _need_card()
    stream, yuv = entry_stream
    with chip_smoke.refuse_plain():
        got, _, counts, per_frame, dec = chip_smoke.api_decode(
            chip_smoke.access_units(stream), len(ENTRY_PATTERN))
    assert got == yuv
    assert dec.md5_ok == 3 * len(ENTRY_PATTERN) and dec.md5_fail == 0
    _check_entry_counts(counts, per_frame)


def _entry_subprocess(tmp_path, cmd):
    hook = tmp_path / "hook"
    hook.mkdir()
    (hook / "sitecustomize.py").write_text(chip_smoke.SITECUSTOMIZE)
    r = subprocess.run(cmd, env=chip_smoke._subprocess_env(str(hook)),
                       capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-3000:] + r.stderr[-3000:]
    c = chip_smoke.read_counts(r.stdout)
    _check_entry_counts(c["launches"], c["h2d_per_frame"])
    return r


@pytest.mark.cuda
def test_cli_on_card(entry_stream, tmp_path):
    """python -m openhevc_tpu_torch.cli with its default backend: rc 0,
    every MD5 correct, the encoder's bytes, every kernel launched."""
    _need_card()
    stream, yuv = entry_stream
    inp, out = tmp_path / "in.265", tmp_path / "out.yuv"
    inp.write_bytes(stream)
    r = _entry_subprocess(tmp_path, [
        sys.executable, "-m", "openhevc_tpu_torch.cli", "-i", str(inp),
        "-o", str(out)])
    n = len(ENTRY_PATTERN)
    assert f"MD5 check: {3 * n} correct, 0 incorrect" in r.stderr
    assert out.read_bytes() == yuv


@pytest.mark.cuda
def test_abi_on_card(entry_stream, tmp_path):
    """tools/abi_driver.c linked to the port's shim, with
    OPENHEVC_TORCH_BACKEND unset (the card): every frame, the encoder's
    bytes, every kernel launched."""
    _need_card()
    from openhevc_tpu_torch.native import build_abi
    stream, yuv = entry_stream
    libdir = os.path.dirname(build_abi())
    drv = str(tmp_path / "abi_driver")
    subprocess.run(["gcc", "-O1", os.path.join(chip_smoke.ROOT, "tools",
                                               "abi_driver.c"),
                    "-o", drv, f"-L{libdir}", "-lLibOpenHevcWrapper",
                    f"-Wl,-rpath,{libdir}"], check=True)
    auf, out = tmp_path / "in.aus", tmp_path / "out.yuv"
    auf.write_bytes(b"".join(struct.pack("<I", len(au)) + au
                             for au in chip_smoke.access_units(stream)))
    r = _entry_subprocess(tmp_path, [drv, str(auf), str(out), "md5"])
    assert f"frames={len(ENTRY_PATTERN)}" in r.stdout
    assert "(openhevc_tpu_torch)" in r.stdout
    assert out.read_bytes() == yuv


# ---------------------------------------------------------------------------
# multi-device paths on one card, and the d5 wire
# ---------------------------------------------------------------------------

def _gops(n_gops, pattern, cfg, seed):
    """An encoder-made stream of n_gops closed GOPs (IDR each) and the
    encoder's reconstruction."""
    enc = Encoder(cfg)
    stream = b"".join(enc.parameter_set_nals())
    rng = np.random.default_rng(seed)
    base = make_source(rng, cfg.width, cfg.height)
    recons = []
    for g in range(n_gops):
        for i, st in enumerate(pattern):
            nal, recon, _ = enc.encode_frame(
                [np.roll(p, 5 * g + i, 0) for p in base], st)
            stream += nal
            recons.append([np.asarray(p).copy() for p in recon])
    return stream, recons


@pytest.mark.cuda
def test_mesh_segments_two_threads_on_card():
    """Two closed-GOP segments decoded at once from two threads on one
    card (MeshDecoder(["cuda:0", "cuda:0"])), each on its own backend and
    compute stream: the encoder's planes, every MD5, exact launches;
    then one open GOP (the same frames, one IDR) over a two-lane device
    schedule."""
    _need_card()
    from openhevc_tpu_torch.parallel import MeshDecoder
    from openhevc_tpu_torch.torch_backend import device
    cfg = EncoderConfig(width=192, height=128, qp=30, log2_ctb=6, sao=True,
                        rng_seed=51)
    stream, recons = _gops(2, "IPP", cfg, 51)
    mdec = MeshDecoder(["cuda:0", "cuda:0"], check_md5=True)
    device.reset_launches()
    frames = mdec.decode_stream(stream)
    assert mdec.md5_ok == 18 and mdec.md5_fail == 0
    assert device.launches()["intra"] == 6
    assert device.launches()["filter"] == 6
    assert_frames_equal([f.planes for f in frames], recons, "segments")
    one, want = _gops(1, "IPPPP", cfg, 52)
    sdec = MeshDecoder(["cuda:0", "cuda:0"], check_md5=True)
    got = sdec.decode_stream(one)
    assert sdec.md5_ok == 15 and sdec.md5_fail == 0
    assert_frames_equal([f.planes for f in got], want, "schedule")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 3, 4])
def test_banded_k4_on_card(k):
    """K4 on k CTB-row bands of a 4:2:0 frame (CTB 64, deblock + SAO +
    restore masks), one launch a band, against unbanded K4 and the plain
    version: tolerance 0."""
    _need_card()
    from openhevc_tpu_torch.torch_backend import device
    from openhevc_tpu_torch.torch_backend import filter as flt
    dev = torch.device("cuda")
    rng = np.random.default_rng(60 + k)
    planes, grids, sao, rs = chip_smoke.k4_frame(rng, dev, 328, 264, 8)
    kw = dict(bd=8, deblock_on=True, sao_on=True, ctb=64, hs=1, vs=1)
    args = (planes, grids, sao, rs)
    device.reset_launches()
    got = flt.filter_bands(*args, [(dev, None)] * k, **kw)
    assert device.launches()["filter"] == k
    want = flt.filter_planes(*args, **kw)
    plain = flt.filter_planes_plain(*args, **kw)
    for g, w, p in zip(got, want, plain):
        assert torch.equal(g, w) and torch.equal(g, p)


@pytest.mark.cuda
def test_sp_dryrun_and_d5_on_card():
    """dryrun_step at 2 and 4 bands, on a given stream and in the
    reference's form (its own encoded stream), and d5 forced on a decode:
    the encoder's planes and every MD5."""
    _need_card()
    from openhevc_tpu_torch.decoder.frontend import Decoder
    from openhevc_tpu_torch.parallel import dryrun_step, make_mesh
    cfg = EncoderConfig(width=192, height=128, qp=30, log2_ctb=4, sao=True,
                        slices=2, rng_seed=53)
    stream, recons = _gops(1, "IPP", cfg, 53)
    for n in (4, 8):
        dryrun_step(make_mesh(devices=["cuda:0"] * n), stream=stream,
                    recons=recons)
        assert len(dryrun_step(make_mesh(devices=["cuda:0"] * n))) == 3
    dec = Decoder(check_md5=True)
    dec.backend._dwire = ((64, 16),) * 3
    frames = dec.decode_stream(stream)
    assert dec.md5_ok == 9 and dec.md5_fail == 0
    assert all(f.wire_fmt[0] == "d5" for f in frames)
    assert_frames_equal([[np.asarray(p) for p in f.host_planes()]
                         for f in frames], recons, "d5")
