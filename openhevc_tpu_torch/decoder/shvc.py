"""SHVC scalable decode: inter-layer reference bridge + 2-layer decoder.

TPU-native redesign of the reference's chained-decoder architecture
(openHevcWrapper.c:106-133, hevc.c:3219-3243): instead of an il-mailbox with
progress conditions (pthread_frame.c:516-624), the base layer decodes first
and the whole-frame upsampled picture + upscaled motion field become an
ordinary DPB entry of the enhancement layer, stored under the current POC —
the slot the decoded EL picture replaces afterwards, which reproduces the
reference's IL-ref lifetime (alloc at frame start, unref after the AU,
hevc.c:3471).  Pixels are bit-exact with per-PU on-demand upsampling
(ACTIVE_PU_UPSAMPLING) because both paths evaluate the same polyphase FIR at
the same frame-global positions.
"""

import numpy as np

from ..bitstream import nal as nalmod
from ..bitstream.nal import split_annexb
from ..model.upsample import UpsampleInfo, upsample_frame, upscale_mv_field
from .refs import Frame
from .frontend import Decoder


_UPSAMPLER = None


def _device_upsampler():
    global _UPSAMPLER
    if _UPSAMPLER is None:
        from ..torch_backend.upsample import CudaUpsampler
        _UPSAMPLER = CudaUpsampler()
    return _UPSAMPLER


def make_il_ref(bl: Frame, el_sps, el_is_irap: bool, nb_list: int,
                el_dpb=None, phase_align: int = 0) -> Frame:
    """Build the inter-layer reference frame for the current EL picture.

    - pixels: whole-frame polyphase upsample (upsample_base_layer_frame,
      hevcdsp_template.c:2164; SNR scalability is a pass-through)
    - motion: 16x16-grid MV-field upscale (ff_upscale_mv_block,
      hevc_filter.c:1311) when the EL picture is not IRAP, zeroed otherwise
      (hevc_refs.c:631-635, init_upsampled_mv_fields)
    - RPL: the BL picture's reference POC lists mapped into the EL DPB
      (set_refindex_data, hevc_refs.c:376-396) — used by TMVP through the
      IL collocated ref
    """
    h_bl, w_bl = bl.planes[0].shape
    w_el, h_el = el_sps.width, el_sps.height
    bd = el_sps.bit_depth
    info = UpsampleInfo(w_bl, h_bl, w_el, h_el, phase_align)
    if not isinstance(bl.planes[0], np.ndarray):
        # BL reconstructed as torch tensors (on the card): upsample there
        # too (bit-exact integer polyphase FIR, torch_backend/upsample.py)
        # — the EL DPB entry stays in device memory and feeds the EL
        # frame_step refs without a host round-trip
        planes = _device_upsampler().upsample_frame(
            bl.planes, w_el, h_el, bit_depth=bd,
            chroma_format_idc=el_sps.chroma_format_idc,
            phase_align_flag=phase_align)
    else:
        planes = upsample_frame([np.asarray(p) for p in bl.planes],
                                w_el, h_el, bit_depth=bd,
                                chroma_format_idc=el_sps.chroma_format_idc,
                                phase_align_flag=phase_align)
    h4, w4 = h_el >> 2, w_el >> 2
    if el_is_irap or bl.mvf_pred is None:
        mv = np.zeros((h4, w4, 2, 2), np.int32)
        ref_idx = np.zeros((h4, w4, 2), np.int8)
        poc = np.zeros((h4, w4, 2), np.int32)
        pred = np.zeros((h4, w4), np.uint8)
        rpl = rpl_lt = None
    else:
        mv, ref_idx, poc, pred = upscale_mv_field(
            bl.mvf_mv, bl.mvf_ref_idx, bl.mvf_poc, bl.mvf_pred,
            w_el, h_el, info, nb_list=nb_list)
        rpl, rpl_lt = [[], []], [[], []]
        if bl.rpl is not None:
            have = el_dpb.frames if el_dpb is not None else {}
            for lx in range(2):
                for i, p in enumerate(bl.rpl[lx] if lx < len(bl.rpl) else []):
                    if p in have:
                        rpl[lx].append(p)
                        rpl_lt[lx].append(bool(bl.rpl_lt[lx][i])
                                          if bl.rpl_lt else False)
    return Frame(poc=bl.poc, planes=planes, mvf_mv=mv, mvf_poc=poc,
                 mvf_pred=pred, mvf_ref_idx=ref_idx, rpl=rpl, rpl_lt=rpl_lt,
                 needed_for_output=False, bit_depth=bd,
                 chroma_format_idc=el_sps.chroma_format_idc)


class ShvcDecoder:
    """Two-layer scalable decoder (BL + one EL, MAX_DECODERS=2 parity).

    ``backend=None`` (the default) reconstructs both layers on the card,
    each through its own ``CudaBackend()``, with the inter-layer upsample
    on the device; ``backend="numpy"`` reconstructs both on the host.

    decode_stream(data) -> list of per-layer frame lists in output order.
    The layer filter inside Frontend.decode_nal routes NALs, mirroring the
    reference's per-decoder nuh_layer_id check (hevc.c:3303).
    """

    def __init__(self, backend=None, check_md5=True, use_native=True,
                 nb_layers=2):
        self.decoders = []
        if backend is None:
            # the card: every layer on its own CudaBackend()
            from ..torch_backend import CudaBackend
            backend = CudaBackend
        for lid in range(nb_layers):
            # `backend` may be a factory (class/callable): then EVERY
            # layer reconstructs on its own backend instance (sticky plan
            # caps are per-geometry, so layers must not share one), and
            # the inter-layer upsample runs on device (make_il_ref).
            # "numpy" reconstructs every layer on the host (recon_np).
            # A plain backend object keeps the legacy meaning: EL only.
            if isinstance(backend, str):
                be = backend
            elif callable(backend):
                be = backend()
            else:
                be = backend if lid else "numpy"
            # only the top layer's pictures leave the device by default
            # (GetOutput targets the highest active layer); lower layers
            # feed the IL upsample in HBM, so their D2H wire prefetch is
            # pure waste on the host link
            d = Decoder(backend=be, check_md5=check_md5,
                        use_native=use_native,
                        prefetch_wire=(lid == nb_layers - 1))
            d.fe.layer_id = lid
            self.decoders.append(d)
        for d in self.decoders[1:]:
            d.fe.il_source = self._il_source
        self._bl_frame = None
        self._seg = [[] for _ in self.decoders]
        self._out = [[] for _ in self.decoders]

    @property
    def md5_ok(self):
        return sum(d.md5_ok for d in self.decoders)

    @property
    def md5_fail(self):
        return sum(d.md5_fail for d in self.decoders)

    def _il_source(self):
        # synchronous BL-before-EL: force the base layer to finish its open
        # picture for this AU (the await_il_progress analog, hevc.c:3224)
        self._finish(0)
        return self._bl_frame

    def _finish(self, lid):
        dec = self.decoders[lid]
        plan = dec.fe.end_picture()
        if plan is not None:
            frame = dec._emit(plan)
            self._seg[lid].append(frame)
            if lid == 0:
                self._bl_frame = frame

    def decode_stream(self, data: bytes):
        for nal in split_annexb(data):
            self.decode_nal(nal)
        self.flush()
        return self._out

    def decode_nal(self, nal):
        lid = nal.layer_id
        if nalmod.is_vcl(nal.type) and nal.rbsp and (nal.rbsp[0] >> 7):
            if lid < len(self.decoders):
                self._finish(lid)
                if nalmod.is_idr(nal.type):
                    dec = self.decoders[lid]
                    self._out[lid].extend(
                        sorted(self._seg[lid], key=lambda f: f.poc))
                    self._seg[lid] = []
                    dec.dpb.clear()
        for dec in self.decoders:
            dec.fe.decode_nal(nal)

    def flush(self):
        for lid in range(len(self.decoders)):
            self._finish(lid)
            self._out[lid].extend(sorted(self._seg[lid], key=lambda f: f.poc))
            self._seg[lid] = []
