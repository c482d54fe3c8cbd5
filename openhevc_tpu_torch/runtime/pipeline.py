"""Pipelined decode: the equivalent of the reference decoder's frame
threads (pthread_frame.c), ported from ``openhevc_tpu/runtime/pipeline.py``.

Three threads and two queues, as in the JAX package:

  parser thread:      NAL demux + CABAC decode -> FramePlan queue.  TMVP
                      needs only the motion field of earlier frames, which
                      the parse itself produces, so the parser runs ahead
                      of reconstruction with a motion-only DPB.
  dispatcher thread:  plan -> prepare_host -> one plan upload -> frame_step
                      on the card, in order, with its own pixel DPB, the
                      reorder buffer and the IDR drain; the MD5 check.
  caller's thread:    takes frames from the output queue.

On the card the frames' work runs on three CUDA streams: the plan upload
on the backend's copy stream, every kernel and torch op on its compute
stream (the dispatcher runs inside ``torch.cuda.stream(compute)``; the
current stream is per thread), and the output wire's copy on its D2H
stream, linked by events.  The dispatch of a frame waits for the device
nowhere; the MD5 check waits for the frame's wire.  All kernels share the
one compute stream: K1 is a spinning wavefront with a bounded wait, and a
kernel beside it on another stream would take SMs from its workers.

The C front-end releases the GIL during the CTU walk, so the parse and the
dispatcher's host work overlap there; the rest of both is Python under one
interpreter lock.
"""

import contextlib
import queue
import threading
import time

import torch

from ..bitstream import nal as nalmod
from ..bitstream.nal import split_annexb
from ..decoder.frontend import Frontend, reconstruct, tally_md5
from ..decoder.refs import DPB, Frame
from ..log import DecodeStats, logger


class PipelinedDecoder:
    """Three-stage pipelined decoder; same results as Decoder.decode_stream.

    ``backend=None`` reconstructs on the card through ``CudaBackend()``
    (raising without a card), ``backend="numpy"`` on the host through
    ``recon_np``; a backend object is used as it is (for example
    ``CudaBackend(device="cpu")``, the kernels' plain versions).
    """

    def __init__(self, backend=None, check_md5=True, use_native=True,
                 depth=4, resilient=False, dispatch_ahead=2,
                 parse_threads=1, prefetch_wire=True):
        if backend is None:
            from ..torch_backend import CudaBackend
            backend = CudaBackend()
        elif isinstance(backend, str):
            if backend != "numpy":
                raise ValueError(f"unknown backend {backend!r}")
            backend = None          # _reconstruct: recon_np
        self.backend = backend
        self.check_md5 = check_md5
        self.use_native = use_native
        # False = the decoded planes are consumed on the device: start no
        # host wire transfers
        self.prefetch_wire = prefetch_wire
        self.parse_threads = parse_threads
        self.depth = depth
        self.resilient = resilient          # drop broken pictures, continue
        # sizes the output queue only: up to max(2, dispatch_ahead + 1)
        # dispatched frames wait there for the caller, whose fetch then
        # overlaps the dispatch of the next ones
        self.dispatch_ahead = dispatch_ahead if backend is not None else 0
        self.dpb = DPB()                    # pixel DPB (reconstruction)
        self.md5_ok = 0
        self.md5_fail = 0
        self.error_count = 0
        self.stats = DecodeStats()

    def decode_stream(self, data: bytes):
        """Decode a whole stream -> frames in output order (list)."""
        return list(self.frames(data))

    def frames(self, data: bytes, max_tid=7, max_frames=0):
        """Generator yielding frames in output (bump) order with bounded
        memory: the reorder buffer holds at most sps_num_reorder_pics frames
        and the pixel DPB is pruned by each picture's RPS."""
        plans_q = queue.Queue(maxsize=self.depth)
        parse_dpb = DPB()                   # motion-only DPB (parse-ahead)
        fe = Frontend(dpb=parse_dpb, use_native=self.use_native,
                      parse_threads=self.parse_threads)
        err = []
        stop = threading.Event()

        def emit_plan(plan, idr):
            # register a motion-only stub so later TMVP parses resolve
            parse_dpb.add(Frame(poc=plan.poc, planes=None,
                                mvf_mv=plan.mvf_mv, mvf_poc=plan.mvf_poc,
                                mvf_pred=plan.mvf_pred,
                                mvf_ref_idx=plan.mvf_ref_idx,
                                rpl=plan.rpl, rpl_lt=plan.rpl_lt))
            while not stop.is_set():
                try:
                    plans_q.put((plan, idr), timeout=0.2)
                    return
                except queue.Full:
                    pass

        def parser():
            try:
                pending_idr = False
                for nal in split_annexb(data):
                    if stop.is_set():
                        break
                    if nal.layer_id != fe.layer_id and \
                            nal.type not in (nalmod.NAL_VPS, nalmod.NAL_SPS):
                        continue    # other layers (SHVC EL NALs)
                    if nalmod.is_vcl(nal.type):
                        if nal.temporal_id > max_tid:
                            continue
                        if nal.rbsp[0] >> 7:
                            plan = fe.end_picture()
                            if plan is not None:
                                emit_plan(plan, pending_idr)
                            pending_idr = nalmod.is_idr(nal.type)
                            if pending_idr:
                                parse_dpb.clear()
                    if self.resilient:
                        # bitstream errors poison only the current picture
                        # (reference continues without AV_EF_EXPLODE)
                        try:
                            fe.decode_nal(nal)
                        except Exception:
                            self.error_count += 1
                            fe._cur = None
                    else:
                        fe.decode_nal(nal)
                if not stop.is_set():
                    try:
                        plan = fe.end_picture()
                    except Exception:
                        if not self.resilient:
                            raise
                        self.error_count += 1
                        plan = None
                    if plan is not None:
                        emit_plan(plan, pending_idr)
            except Exception as e:          # surfaced on the caller's thread
                err.append(e)
            finally:
                while not stop.is_set():
                    try:
                        plans_q.put(None, timeout=0.2)
                        break
                    except queue.Full:
                        pass

        t = threading.Thread(target=parser, name="pipeline-parser",
                             daemon=True)
        t.start()

        # the dispatcher runs on its own thread so that the caller's fetch
        # of one frame overlaps the next frames' host preparation (the
        # reference's analog is the frame-thread handoff at
        # ff_thread_finish_setup, hevc.c:3271)
        out_q = queue.Queue(maxsize=max(2, self.dispatch_ahead + 1))

        def put_out(f):
            while not stop.is_set():
                try:
                    out_q.put(f, timeout=0.2)
                    return True
                except queue.Full:
                    pass
            return False

        def get_plan():
            while not stop.is_set():
                try:
                    return plans_q.get(timeout=0.2)
                except queue.Empty:
                    pass
            return None

        def dispatcher():
            reorder = []                    # frames awaiting output, by POC
            try:
                with self._compute_stream():
                    while True:
                        item = get_plan()
                        if item is None:
                            break
                        plan, is_idr = item
                        if is_idr:
                            reorder.sort(key=lambda f: f.poc)
                            for f in reorder:
                                if not put_out(f):
                                    return
                            reorder = []
                            self.dpb.clear()
                        t0 = time.monotonic()
                        frame = self._reconstruct(plan)
                        self.stats.frames_decoded += 1
                        self.stats.decode_time_s += time.monotonic() - t0
                        logger.debug("dispatched poc %d type %d in %.1f ms",
                                     plan.poc, plan.slice_type,
                                     (time.monotonic() - t0) * 1e3)
                        self.dpb.add(frame)
                        if plan.ref_keep is not None:
                            self.dpb.retain(set(plan.ref_keep) | {plan.poc})
                        if self.check_md5 and plan.md5 is not None:
                            self._verify_md5(frame, plan.md5,
                                             plan.bit_depth)
                        reorder.append(frame)
                        reorder.sort(key=lambda f: f.poc)
                        while len(reorder) > plan.num_reorder_pics:
                            if not put_out(reorder.pop(0)):
                                return
                        if stop.is_set():
                            return
                reorder.sort(key=lambda f: f.poc)
                for f in reorder:
                    if not put_out(f):
                        return
            except Exception as e:          # surfaced on the caller's thread
                err.append(e)
            finally:
                while not stop.is_set():
                    try:
                        out_q.put(None, timeout=0.2)
                        break
                    except queue.Full:
                        pass

        td = threading.Thread(target=dispatcher, name="pipeline-dispatcher",
                              daemon=True)
        td.start()

        emitted = 0
        try:
            while True:
                f = out_q.get()
                if f is None:
                    break
                self._hand_over(f)
                yield f
                emitted += 1
                if max_frames and emitted >= max_frames:
                    return
            if err:
                # unblock the producer threads before joining: the parser
                # may be spinning on a full plans_q after the dispatcher
                # died mid-stream
                stop.set()
            t.join()
            td.join()
            if err:
                raise err[0]
        finally:
            # early exits (max_frames, an error in the caller's thread)
            # end both threads too: every wait in them polls `stop`
            stop.set()
            t.join()
            td.join()

    def _compute_stream(self):
        """The dispatcher's stream context: the backend's compute stream on
        the card, nothing elsewhere."""
        stream = getattr(self.backend, "compute_stream", None)
        if stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(stream)

    @staticmethod
    def _hand_over(frame):
        """Before a frame leaves the pipeline: K1's check (a frame that is
        never fetched still raises), and on the card the caller's stream
        made to wait for the frame's planes, which the allocator then
        keeps until that stream is done with them."""
        wire = frame.wire
        if wire is None:
            return
        wire.check()
        if wire.ready is not None:
            cur = torch.cuda.current_stream(wire.wire.device)
            cur.wait_event(wire.ready)
            for p in frame.planes:
                p.record_stream(cur)

    def _reconstruct(self, plan) -> Frame:
        return reconstruct(self.backend, plan, self.dpb, self.prefetch_wire)

    def _verify_md5(self, frame, expected, bit_depth):
        tally_md5(self, frame, expected, bit_depth, raise_on_mismatch=False)
