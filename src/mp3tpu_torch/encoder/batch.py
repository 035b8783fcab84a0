"""Batched multi-stream encoder (SURVEY.md §3.4).

Counterpart of mp3tpu.encoder.batch. encode_batch() is the encoder's
aggregate-throughput path: many streams encode together, and the spectra
stay DEVICE-RESIDENT from the analysis transform through the rate loops;
the host sees only small control tensors plus the coded bytes:

  stage PCM            once: int16-origin streams quantized on the host
                       into a reused pinned int16 buffer, one H2D, then
                       trimmed and dequantized on the device; other input
                       as float32
  block-type labels    float64 sub-block energies on the device (for
                       int16-origin input; on the host otherwise), the
                       decision on the host
  E1+E2 transform      device -> spectra [B*nch, G, 576]
  E3 psymodel 2        device, on the SAME staged pcm
  MS decision + xmin   device (energies down, masks up: KBs)
  E4 rate/distortion   device loops per block-type group, rows GATHERED
                       on the device (vloop_device.*_gathered); the
                       device's final f32 quantize IS the emitted
                       spectrum and its integer bit count / table
                       selection is exact for it (count == emit)
  reservoir control    host per stream (two-pass deterministic walk,
                       same policy as encode_pcm: SURVEY.md §7.5-5
                       keeps loop CONTROL on host)
  E5/E6 emission       device emitter (emit_device, bit for bit the
                       Python encode_granule): only the packed bytes come
                       down; then the packed mux (mux_packed)

The single-stream encode_pcm (numpy lockstep, f64 scalar-exact) is the
reference; encode_batch's device search differs from it only by half-step
rounding at f32 quantization boundaries (still a valid quantizer) while
honoring the same budget/reservoir contracts: every granule's EXACT coded
size is known before mux, and a per-frame overdraft guard refits against
the true reservoir. Streams must share sample_rate/channel count; mixed
batches fall back to encode_pcm.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from ..container.frames import BITRATES_V1_L3
from ..utils.profiling import annotate, request
from . import emit_device, vloop, vloop_device
from .huffcode import encode_granule
from .mux import FrameSizer, ReservoirMux, build_xing_frame, \
    frame_capacity_bits
from .psymodel import (MDCT_ALIGN, align_to_mdct, block_type_sequence,
                       block_types_from_subblock_energy)
from . import ENCODER_DELAY, SPF, SR_IDX
from .tables import band_sums, encoder_tables

S2 = 1.0 / np.sqrt(2.0)

# last MP3TPU_ENCODE_PROFILE=1 phase walls
LAST_PROFILE: dict = {}
# Pass B upgrades only frames whose budget bump is MATERIAL (> this many bits
# per granule-channel). Pass A's reservoir walk is a lower bound that loses a
# few bits a frame to worst-case byte-alignment pessimism, so with a margin
# of 0 nearly every frame "upgrades" by a few bits and gets re-quantized on
# the device for no audible gain. Kept frames stay coded at their pass-A
# budget (always conformant: coding under budget is legal) and their EXACT
# coded size feeds the walk, which is what actually grows the reservoir for
# the loud frames that need real upgrades. Genuine reclaims (quiet stretch ->
# transient) are hundreds of bits and sail over the margin; at 128 kbps
# stereo a skipped 96-bit bump is about 2% of a frame's budget.
UPGRADE_MARGIN = 96


class _Phases:
    """The phases of one encode_batch: each a named range
    (utils.profiling.annotate) and, under MP3TPU_ENCODE_PROFILE=1, a wall
    that ends with the device's queue drained, so that it holds the phase's
    device work."""

    def __init__(self, device):
        self.prof = os.environ.get("MP3TPU_ENCODE_PROFILE") == "1"
        self.device = device
        self.walls: dict = {}
        self._span = None
        self._t0 = time.perf_counter()

    def start(self, name):
        self.close()
        self._name = name
        self._span = annotate("mp3tpu.encode." + name)
        self._span.__enter__()

    def close(self):
        if self._span is None:
            return
        self._span.__exit__(None, None, None)
        self._span = None
        if self.prof:
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            t = time.perf_counter()
            self.walls[self._name] = (self.walls.get(self._name, 0.0)
                                      + t - self._t0)
            self._t0 = t


def _energies(X: torch.Tensor, nch: int):
    """X [B*nch, G, 576] -> per-granule channel energies [B, nch, G] and
    (for stereo) mid/side energies [B, G] for the frame MS decision."""
    Bn, G, _ = X.shape
    X2 = X.reshape(Bn // nch, nch, G, 576)
    e_gc = (X2 * X2).sum(dim=3)
    if nch == 2:
        mid = (X2[:, 0] + X2[:, 1]) * S2
        side = (X2[:, 0] - X2[:, 1]) * S2
        e_m = (mid * mid).sum(dim=2)
        e_s = (side * side).sum(dim=2)
    else:
        e_m = e_s = X.new_zeros(Bn // nch, G)
    return e_m, e_s, e_gc


def _prep(t, X, nch: int, msg, ratio_l, ratio_s, short_row):
    """Apply mid/side on flagged granules and build the loop inputs, all on
    the device.

    X [B*nch, G, 576]; msg [B, G] bool; ratio_l [B*nch, G, 21]; ratio_s
    [B*nch, G, 3, 12]; short_row [B*G*nch] bool. Returns rows [B*G*nch,
    576], xmin_l [., 21], xmin_s [., 3, 12] (row id = (b*G + g)*nch + c)."""
    Bn, G, _ = X.shape
    B = Bn // nch
    X2 = X.reshape(B, nch, G, 576)
    rl = ratio_l.reshape(B, nch, G, 21)
    rs = ratio_s.reshape(B, nch, G, 3, 12)
    if nch == 2:
        mid = (X2[:, 0] + X2[:, 1]) * S2
        side = (X2[:, 0] - X2[:, 1]) * S2
        m = msg[:, None, :, None]
        X2 = torch.where(m, torch.stack([mid, side], 1), X2)
        both_l = torch.minimum(rl[:, 0], rl[:, 1])[:, None]
        both_s = torch.minimum(rs[:, 0], rs[:, 1])[:, None]
        rl = torch.where(m, both_l, rl)
        rs = torch.where(msg[:, None, :, None, None], both_s, rs)
    rows = X2.permute(0, 2, 1, 3).reshape(-1, 576)
    rl_rows = rl.permute(0, 2, 1, 3).reshape(-1, 21)
    rs_rows = rs.permute(0, 2, 1, 3, 4).reshape(-1, 3, 12)
    rs_rows = torch.where(short_row[:, None, None], rs_rows, 1e9)
    p2 = rows * rows
    en_l = band_sums(p2, t.long_lines)
    en_s = band_sums(p2, t.short_lines).reshape(-1, 3, 13)[:, :, :12]
    return rows, rl_rows * en_l, rs_rows * en_s


def encode_batch(pcms, sample_rate: int | None = None,
                 bitrate: int | None = None,
                 gapless_tag: bool | None = None,
                 short_blocks: bool | None = None,
                 joint_stereo: bool | None = None,
                 noise_shaping: bool | None = None,
                 reservoir: bool = True, device=None,
                 mesh=None) -> list[bytes]:
    """Encode a batch of float PCM arrays ([n] or [n, ch], same channel
    count and sample rate) to MP3 bytes. See module docstring.

    pcms may also be a DecodedBatch handle (decode_batch(...,
    output="device")): the device-resident transcode path. The int16
    PCM is trimmed/dequantized/padded in device memory (one gather per
    decode chunk) and block-type labels come from a device sub-block
    energy reduction: no staging H2D and no decode D2H. sample_rate
    is inferred from the handle (must be uniform), and the encode runs
    where the handle's PCM lies. Output is bit-identical to encoding the
    handle's .numpy() PCM: the float64 device energies that the labels are
    decided from equal the host's float64 ones exactly for int16 PCM.
    Host-fallback records and mixed channel counts materialize to the host
    path (correct, not zero-copy).

    A float batch whose every sample is int16-origin (k/32768) is staged the
    same way: quantized once on the host into int16, one H2D, labels from
    the device's energies. Any other float batch is staged as float32 and
    labelled on the host; both give the bytes of the float32 staging with
    float64 host labels.

    Unset parameters fall back to the active EncodeConfig (SURVEY.md
    §5.6), mirroring encode_pcm. device ("cuda" unless given) is where the
    device stages run. Every row is emitted on the device, with the
    reservoir on or off (emit_device: one emitter); on a card the C++ mux is
    required (no Python fallback), as the C++ unpacker is for the decode.

    mesh (a parallel.StreamMesh) splits the streams by its stream_sharding:
    each shard's streams are encoded on that shard's device (on a card, on a
    CUDA stream of the shard's own; the host starts the shards in turn), and
    the MP3s come back in stream order, byte for byte those of the unsharded
    call. A DecodedBatch with mesh set goes through the host. A `device`
    that is not one of the mesh's raises ValueError."""
    with request("mp3tpu.encode_batch", len(pcms)):
        from ..config import get_active
        ecfg = get_active().encode
        bitrate = ecfg.bitrate if bitrate is None else bitrate
        gapless_tag = ecfg.gapless_tag if gapless_tag is None else gapless_tag
        short_blocks = ecfg.short_blocks if short_blocks is None else short_blocks
        joint_stereo = ecfg.joint_stereo if joint_stereo is None else joint_stereo
        noise_shaping = (ecfg.noise_shaping if noise_shaping is None
                         else noise_shaping)
        if bitrate not in BITRATES_V1_L3:
            raise ValueError("unsupported bitrate")
        is_dev_batch = (hasattr(pcms, "device_pcm")
                        and hasattr(pcms, "sample_rates"))
        if not is_dev_batch and sample_rate not in SR_IDX:
            raise ValueError("unsupported sample rate")
        # ---- device-resident input (DecodedBatch, SURVEY.md §3.2) -----------
        # transcode path: decode_batch(output="device") -> encode_batch: the
        # PCM stays on the device (no stage H2D, no decode D2H). Host-fallback
        # records and mixed channels materialize to the host path below
        # (correct, just not zero-copy).
        recs = None
        if is_dev_batch:
            with annotate("mp3tpu.encode.device_input", len(pcms)):
                rates = set(pcms.sample_rates)
                if len(rates) != 1:
                    raise ValueError("device-batch encode needs one sample rate, "
                                     f"got {sorted(rates)}")
                rate = rates.pop()
                if sample_rate is not None and sample_rate != rate:
                    raise ValueError(
                        f"sample_rate {sample_rate} != decoded {rate}")
                sample_rate = rate
                if sample_rate not in SR_IDX:
                    raise ValueError("unsupported decoded sample rate")
                recs = [pcms.device_pcm(i) for i in range(len(pcms))]
                nchs = {r[4] for r in recs}
                on = [r[0].device for r in recs if isinstance(r[0], torch.Tensor)]
                if on and mesh is None:  # the encode runs where the PCM lies
                    device = on[0]
                if (mesh is not None or len(nchs) != 1 or next(iter(nchs)) > 2
                        or len(on) < len(recs)):
                    pcms = [p.astype(np.float64) / 32768.0
                            for p, _sr in pcms.numpy()]
                    recs = None
        if mesh is not None:
            _check_mesh_device(mesh, device)  # and the mesh's devices rule below
        else:
            device = torch.device("cuda" if device is None else device)

        arrs = []
        if recs is None:
            for p in pcms:
                a = np.asarray(p, np.float64)
                if a.ndim == 1:
                    a = a[:, None]
                arrs.append(a)
            nchs = {a.shape[1] for a in arrs}
            if len(nchs) != 1 or arrs[0].shape[1] > 2:
                # stream by stream, each on its shard's device
                from . import encode_pcm
                devs = ([device] * len(arrs) if mesh is None else
                        [dev for dev, sl in zip(mesh.devices, _slices(mesh, len(arrs)))
                         for _ in range(sl.start, sl.stop)])
                return [encode_pcm(a, sample_rate, bitrate=bitrate,
                                   gapless_tag=gapless_tag,
                                   short_blocks=short_blocks,
                                   joint_stereo=joint_stereo,
                                   noise_shaping=noise_shaping,
                                   reservoir=reservoir, device=dev)
                        for a, dev in zip(arrs, devs)]
        def run(part, part_recs, dev):
            phases = _Phases(dev)
            try:
                return _encode_batch(part, part_recs, sample_rate, bitrate,
                                     gapless_tag, short_blocks, joint_stereo,
                                     noise_shaping, reservoir, dev, phases)
            finally:
                phases.close()

        if mesh is None:
            return run(arrs, recs, device)
        out = []
        for dev, sl in zip(mesh.devices, _slices(mesh, len(arrs))):
            if sl.start == sl.stop:
                continue
            if dev.type != "cuda":
                out += run(arrs[sl], None, dev)
                continue
            # the shard's own stream, behind what the device's current stream
            # holds. _encode_batch ends with its results on the host, so the
            # shards still run one after the other: the stream keeps a shard's
            # work apart from the caller's, and overlap between shards waits for
            # an encode that submits every shard before it collects any
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.device(dev), torch.cuda.stream(side):
                out += run(arrs[sl], None, dev)
            torch.cuda.current_stream(dev).wait_stream(side)
        return out


def _slices(mesh, n_streams: int):
    """The mesh's slices of n_streams streams, one per shard."""
    from ..parallel.mesh import stream_sharding
    return stream_sharding(mesh).slices(n_streams)


def _check_mesh_device(mesh, device) -> None:
    """ValueError unless `device` (None: whatever the mesh says) names a
    device of the mesh; a bare "cuda" or "cpu" names every device of its
    kind."""
    if device is None:
        return
    dev = torch.device(device)
    if not any(d.type == dev.type and (dev.index is None or d.index == dev.index)
               for d in mesh.devices):
        raise ValueError(f"encode_batch: device {device} is not one of the "
                         f"mesh's {[str(d) for d in mesh.devices]}")


def _encode_batch(arrs, recs, sample_rate, bitrate, gapless_tag, short_blocks,
                  joint_stereo, noise_shaping, reservoir, device,
                  phases) -> list[bytes]:
    """encode_batch on resolved arguments: float64 arrays [n, nch] (recs
    None), or the DecodedBatch's device records."""
    from . import device as tdev
    from .device import (gather_rows, granule_spectra_device_handle,
                         stage_int16, stage_pcm, subblock_energy)
    on_card = device.type == "cuda"
    _prof = phases.prof
    _ph = phases.walls
    phases.start("host_prep")
    if recs is None:
        nch = arrs[0].shape[1]
        B = len(arrs)
    else:
        nch = recs[0][4]
        B = len(recs)
    sr_idx = SR_IDX[sample_rate]
    br_idx = BITRATES_V1_L3.index(bitrate)

    # ---- per-stream granule counts --------------------------------------
    G_s, encpad_s = [], []
    ns = ([len(a) for a in arrs] if recs is None
          else [int(r[3] - r[2]) for r in recs])
    for n in ns:
        total_needed = n + ENCODER_DELAY + 529
        G = -(-total_needed // SPF)
        G += G & 1
        G_s.append(G)
        encpad_s.append(G * SPF - ENCODER_DELAY - n)
    Gmax = max(G_s)

    # ---- stage once; transform + psymodel on device ---------------------
    phases.start("stage")
    T = Gmax * SPF
    pcm_bnt = None
    if recs is not None:
        # one gather per run of streams sharing a decode chunk: trim +
        # dequantize + zero-pad in device memory (device.gather_rows)
        blocks = []
        i = 0
        while i < B:
            chunk = recs[i][0]
            k = i
            while k < B and recs[k][0] is chunk:
                k += 1
            blocks.append(gather_rows(
                chunk, [recs[j][1] for j in range(i, k)],
                [recs[j][2] for j in range(i, k)], ns[i:k], T, nch))
            i = k
        pcm_bnt = blocks[0] if len(blocks) == 1 else torch.cat(blocks)
    elif not tdev.FORCE_F32_STAGE:
        # int16-origin streams: one int16 pass on the host, one H2D, and
        # the same gather as the transcode's
        chunk = stage_int16(arrs, device)
        if chunk is not None:
            pcm_bnt = gather_rows(chunk, range(B), [0] * B, ns, T, nch)
            del chunk
    if pcm_bnt is not None:
        # labels from float64 device energies: reduction on the device,
        # decision on the host (the shared block_types_from_subblock_energy);
        # for int16-origin PCM the energies, and so the labels, are the
        # host's float64 ones exactly (device.subblock_energy)
        with annotate("mp3tpu.encode.labels", B) as sp:
            sp.outcome = "device"
            if short_blocks:
                e = subblock_energy(pcm_bnt, MDCT_ALIGN).cpu().numpy()
                bts_s = [block_types_from_subblock_energy(e[s, : G_s[s] * 9])
                         for s in range(B)]
            else:
                bts_s = [np.zeros(G, np.int64) for G in G_s]
        pcm_dev = pcm_bnt.reshape(B * nch, T)
        del pcm_bnt  # so that `del pcm_dev` below frees the staged PCM
        staged_i16 = True
    else:
        pad_s = []
        for s, n in enumerate(ns):
            padded = np.zeros((G_s[s] * SPF, nch))
            padded[:n] = arrs[s]
            pad_s.append(padded)
        pcm_b = np.zeros((B * nch, T), np.float32)
        for s in range(B):
            for c in range(nch):
                pcm_b[s * nch + c, : G_s[s] * SPF] = pad_s[s][:, c]
        pcm_dev, staged_i16 = stage_pcm(pcm_b, device)
        # block-type labels on the MDCT-aligned copy (psymodel.MDCT_ALIGN:
        # granule g's spectrum holds time content delayed by the analysis
        # chain, so unshifted labels switch one granule early), computed
        # after the staging copy is queued, so that this host work runs
        # beside it
        with annotate("mp3tpu.encode.labels", B) as sp:
            sp.outcome = "host"
            bts_s = [block_type_sequence(align_to_mdct(pad_s[s]), sample_rate)
                     if short_blocks else np.zeros(G_s[s], np.int64)
                     for s in range(B)]
    bts_b = np.zeros((B * nch, Gmax), np.int64)
    for s in range(B):
        for c in range(nch):
            bts_b[s * nch + c, : G_s[s]] = bts_s[s]
    if _prof:
        _ph['stage_int16'] = int(staged_i16)
    phases.start("transform_psy")
    tables = encoder_tables(sample_rate, device)
    X = granule_spectra_device_handle(pcm_dev, bts_b, sample_rate)
    if noise_shaping:
        from .psy_device import analyze_batch_handle
        # align: the staged pcm is unshifted (the MDCT shares it); the
        # psymodel's analysis frames start MDCT_ALIGN earlier instead
        rl_dev, rs_dev = analyze_batch_handle(pcm_dev, Gmax, sample_rate,
                                              align=MDCT_ALIGN)
    else:
        rl_dev = X.new_zeros(B * nch, Gmax, 21)
        rs_dev = X.new_zeros(B * nch, Gmax, 3, 12)
    del pcm_dev

    # ---- MS decision from device energies -------------------------------
    phases.start("energies")
    e_m, e_s, e_gc = vloop_device.to_host(_energies(X, nch))
    e_gc = e_gc.astype(np.float64)                         # [B, nch, G]
    ms_s = []
    msg_b = np.zeros((B, Gmax), bool)
    for s in range(B):
        n_frames = G_s[s] // 2
        ms_f = np.zeros(n_frames, bool)
        if nch == 2 and joint_stereo:
            em = e_m[s, : G_s[s]].reshape(n_frames, 2).sum(1)
            es = e_s[s, : G_s[s]].reshape(n_frames, 2).sum(1)
            ms_f = es < 0.5 * em
            msg_b[s, : G_s[s]] = np.repeat(ms_f, 2)
        ms_s.append(ms_f)

    # ---- device prep: MS butterfly + xmin rows (stay on device) ---------
    # row id in the padded layout: (b*Gmax + g)*nch + c
    phases.start("prep")
    bt_pad = np.zeros((B, Gmax, nch), np.int64)
    for s in range(B):
        bt_pad[s, : G_s[s]] = bts_s[s][:, None]
    short_row = (bt_pad.reshape(-1) == 2)
    rows_dev, xminl_dev, xmins_dev = _prep(
        tables, X, nch, torch.from_numpy(msg_b).to(device), rl_dev, rs_dev,
        torch.from_numpy(short_row).to(device))
    del X, rl_dev, rs_dev

    # valid-row ids (skips pad granules), aligned with the frame-major gc
    # order the mux consumes
    vid_parts = []
    for s in range(B):
        g = np.arange(G_s[s])
        vid_parts.append(((s * Gmax + g)[:, None] * nch
                          + np.arange(nch)).ravel())
    vid = np.concatenate(vid_parts)
    offs = np.cumsum([0] + [G_s[s] * nch for s in range(B)])
    n_gc = int(offs[-1])
    bt_all = np.concatenate([np.repeat(bts_s[s], nch) for s in range(B)])

    # ---- pass-A budgets: per-stream pessimistic reservoir walk ----------
    phases.start("passA_walk")
    cap_s, base_s, loud_s, feed_s, granted_s = [], [], [], [], []
    for s in range(B):
        n_frames = G_s[s] // 2
        sizer = FrameSizer(sample_rate, bitrate * 1000)
        fsizes = [sizer.next() for _ in range(n_frames)]
        cap_f = np.array([frame_capacity_bits(fb, nch) for fb, _ in fsizes],
                         np.int64)
        base_f = cap_f // (2 * nch) - 8
        if reservoir:
            f_energy = e_gc[s, :, : G_s[s]].sum(0).reshape(
                n_frames, 2).sum(1) + 1e-12
            loud_f = (f_energy > 2.0 * float(np.median(f_energy))) | \
                (bts_s[s].reshape(n_frames, 2) == 2).any(1)
            base_f = np.minimum(base_f, 3900)
        else:
            loud_f = np.zeros(n_frames, bool)
        horizon = 16
        upcoming = np.zeros(n_frames, bool)
        if loud_f.any():
            nxt = np.minimum.accumulate(
                np.where(loud_f, np.arange(n_frames), 1 << 30)[::-1])[::-1]
            upcoming = (nxt - np.arange(n_frames)) <= horizon
        feed_f = np.where(loud_f | ~upcoming, 0, 64)
        if reservoir:
            granted = np.empty(n_frames, np.int64)
            res_lb = 0
            cap_res = ReservoirMux.MAX_BACK * 8
            for f in range(n_frames):
                avail = min(max(res_lb, 0), 3000)
                if loud_f[f]:
                    bud = base_f[f] + avail // (2 * nch)
                else:
                    bud = base_f[f] - feed_f[f] + (avail // 8) // (2 * nch)
                granted[f] = int(min(bud, 3900))
                res_lb = min(res_lb + cap_f[f] - 2 * nch * granted[f] - 7,
                             cap_res)
        else:
            granted = base_f.copy()
        cap_s.append(cap_f)
        base_s.append(base_f)
        loud_s.append(loud_f)
        feed_s.append(feed_f)
        granted_s.append(granted)

    # ---- device quantization and emission -------------------------------
    # every row is emitted on the device (encoder/emit_device.py): the
    # packed part2+part3 bytes come to the host, not the spectra
    phases.start("passA")
    CAP = emit_device.CAP_WORDS * 4
    bits_bytes = np.zeros((n_gc, CAP), np.uint8)
    meta = np.zeros((n_gc, 5), np.int32)
    p23 = np.zeros(n_gc, np.int64)
    gg_a = np.full(n_gc, 210, np.int64)
    lsf_a = np.zeros((n_gc, 21), np.int64)
    ssf_a = np.zeros((n_gc, 3, 12), np.int64)
    sbg_a = np.zeros((n_gc, 3), np.int64)
    hbits_a = np.zeros(n_gc, np.int64)
    tsel_a = np.zeros((n_gc, 3), np.int64)
    c1t_a = np.zeros(n_gc, np.int64)

    def quantize_rows_dev(idx, budgets, plan=False):
        """Run the device loops for the gc indices idx (0..n_gc) at the
        budgets aligned with them, one group per kind of row; the results
        stay on the device. Returns pend_list, whose entries (gc_ids, kind,
        layout, _Pending) go to finalize_pending once the caller knows
        which rows it keeps: most pass-A rows of an upgraded frame are
        re-quantized by pass B, so they are never emitted.

        plan=True also downloads what the pass-B planning consumes (bits
        and scalefactors) into hbits_a, lsf_a and ssf_a."""
        b = budgets.astype(np.int64)
        btr = bt_all[idx]
        shaped_l = (btr != 2) & noise_shaping
        shaped_s = (btr == 2) & noise_shaping
        plain = ~shaped_l & ~shaped_s
        pend_list = []
        # long-LAYOUT rows: 0 plus start/stop 1/3 (long spectrum + long
        # sfb shaping; block_type switches the region split)
        vd = vloop_device
        for bt in (0, 1, 3):
            sel = np.nonzero(shaped_l & (btr == bt))[0]
            if not len(sel):
                continue
            pend = vd.outer_rows_gathered_pending(
                rows_dev, xminl_dev, vid[idx[sel]], b[sel], sample_rate,
                block_type=int(bt))
            if plan:
                lsf_a[idx[sel]], hbits_a[idx[sel]] = pend.take("sf", "bits")
            pend_list.append((idx[sel], "long",
                              "long" if bt == 0 else "switched", pend))
        if shaped_s.any():
            sel = np.nonzero(shaped_s)[0]
            pend = vd.outer_rows_short_gathered_pending(
                rows_dev, xmins_dev, vid[idx[sel]], b[sel], sample_rate)
            if plan:
                ssf_a[idx[sel]], hbits_a[idx[sel]] = pend.take("sf", "bits")
            pend_list.append((idx[sel], "short", "short", pend))
        if plain.any():
            for bt in np.unique(btr[plain]):
                sel = np.nonzero(plain & (btr == bt))[0]
                pend = vd.rate_rows_gathered_pending(
                    rows_dev, vid[idx[sel]], b[sel], sample_rate, int(bt))
                if plan:
                    (hbits_a[idx[sel]],) = pend.take("bits")
                lay = ("long" if bt == 0
                       else "short" if bt == 2 else "switched")
                pend_list.append((idx[sel], "rate", lay, pend))
        return pend_list

    def finalize_pending(pend_list, keep_mask, verify_p23=False):
        """Emit the rows keep_mask selects on the device and download their
        packed part2+part3 BYTES and side-info fields
        (_Pending.emit_and_take) into bits_bytes, meta, p23 and the side-info
        arrays. Entries carry the GLOBAL gc ids of their rows. verify_p23
        pins the count==emit contract against the host-side pass-A
        predictions."""
        for gids, kind, layout, pend in pend_list:
            loc = np.nonzero(keep_mask[gids])[0]
            if not len(loc):
                continue
            tgt = gids[loc]
            vloop_device.take_iter_stats(pend, layout)  # telemetry
            by, m5, gg, tcols, c1, hb, sbg = pend.emit_and_take(
                layout, kind != "rate", loc)
            bits_bytes[tgt] = by
            meta[tgt] = m5
            gg_a[tgt] = gg
            tsel_a[tgt] = vloop_device._TID[tcols.astype(np.int64)]
            c1t_a[tgt] = c1
            if sbg is not None:
                sbg_a[tgt] = sbg
            # count == emit, device-to-device: the emitter's bit total must
            # equal the count's huffman bits plus the scalefactor side bits
            # its sfc implies
            sfc = m5[:, 2].astype(np.int64)
            if layout == "short":
                sfb = 18 * (vloop._SLEN1[sfc] + vloop._SLEN2[sfc])
            else:
                sfb = 11 * vloop._SLEN1[sfc] + 10 * vloop._SLEN2[sfc]
            assert np.array_equal(m5[:, 0].astype(np.int64),
                                  hb.astype(np.int64) + sfb), \
                "device emitter/count drift"
            if verify_p23:  # vs the host pass-A prediction
                assert np.array_equal(m5[:, 0].astype(np.int64),
                                      p23[tgt]), "emitter/p23 drift"
            p23[tgt] = m5[:, 0]

    def p23_of(idx):
        """part2_3_length = exact huffman bits + scalefactor side bits."""
        p = hbits_a[idx].copy()
        btr = bt_all[idx]
        if noise_shaping:
            lm = btr != 2
            if lm.any():
                sfc = vloop.pick_sfc_rows(lsf_a[idx[lm]])
                p[lm] += 11 * vloop._SLEN1[sfc] + 10 * vloop._SLEN2[sfc]
            sm = btr == 2
            if sm.any():
                sfc = vloop.pick_sfc_short_rows(ssf_a[idx[sm]])
                p[sm] += 18 * (vloop._SLEN1[sfc] + vloop._SLEN2[sfc])
        return p

    idx_all = np.arange(n_gc)
    budgets_a = np.concatenate([np.repeat(granted_s[s], 2 * nch)
                                for s in range(B)])
    # with the reservoir, pass A downloads only what the upgrade walk
    # consumes (bits and scalefactors); the spectra stay on the device until
    # it is known which rows pass B re-quantizes
    pend_a = quantize_rows_dev(idx_all, budgets_a, plan=reservoir)
    if reservoir:
        p23 = p23_of(idx_all)

    # ---- pass-B upgrade walk per stream, one batched re-quantize --------
    phases.start("passB")
    keep_mask = np.ones(n_gc, bool)
    pend_b = None
    if reservoir:
        _deltas = [] if _prof else None
        upg_idx_parts, upg_bud_parts = [], []
        for s in range(B):
            n_frames = G_s[s] // 2
            granted = granted_s[s]
            cap_f = cap_s[s]
            fsum = p23[offs[s]: offs[s + 1]].reshape(n_frames, 2 * nch).sum(1)
            final = granted.copy()
            stream_bits = 0
            placed_bytes = 0
            loud_f, base_f, feed_f = loud_s[s], base_s[s], feed_s[s]
            for f in range(n_frames):
                res = placed_bytes * 8 - stream_bits
                avail = min(max(res, 0), 3000)
                if loud_f[f]:
                    want = base_f[f] + avail // (2 * nch)
                else:
                    want = base_f[f] - feed_f[f] + (avail // 8) // (2 * nch)
                want = int(min(want, 3900))
                if _deltas is not None and want > granted[f]:
                    _deltas.append(want - granted[f])
                if want > granted[f] + UPGRADE_MARGIN:
                    final[f] = want
                    used = 2 * nch * want
                else:
                    used = int(fsum[f])
                stream_bits = (stream_bits + used + 7) & ~7
                placed_bytes += int(cap_f[f]) // 8
                excess = (placed_bytes - stream_bits // 8
                          - ReservoirMux.MAX_BACK)
                if excess > 0:
                    stream_bits += excess * 8
            upg_f = np.nonzero(final > granted)[0]
            if len(upg_f):
                gidx = (offs[s] + upg_f[:, None] * 2 * nch
                        + np.arange(2 * nch)).ravel()
                upg_idx_parts.append(gidx)
                upg_bud_parts.append(np.repeat(final[upg_f], 2 * nch))
                granted_s[s] = final
        if _deltas is not None and _deltas:
            d = np.sort(np.asarray(_deltas))
            _ph['upg_want_gt_granted'] = len(d)
            _ph['upg_delta_p50'] = int(d[len(d) // 2])
            _ph['upg_delta_p90'] = int(d[(len(d) * 9) // 10])
            _ph['upg_delta_max'] = int(d[-1])
        if upg_idx_parts:
            uidx = np.concatenate(upg_idx_parts)
            keep_mask[uidx] = False
            if _prof:
                _ph['upgraded_rows'] = len(uidx)
                _ph['total_rows'] = n_gc
            pend_b = quantize_rows_dev(uidx, np.concatenate(upg_bud_parts))

    phases.start("emit")
    finalize_pending(pend_a, keep_mask, verify_p23=reservoir)
    if pend_b is not None:
        finalize_pending(pend_b, ~keep_mask)
    pend_a = pend_b = None
    # emission must agree with the predicted exact counts: this is the
    # count == emit contract the reservoir replay depends on
    assert np.array_equal(meta[:, 0].astype(np.int64), p23), \
        "emitter/count drift"

    def rows_host(gi):
        """Download the few rows a refit needs (rare overdrafts)."""
        sel = torch.from_numpy(vid[gi]).to(device)
        return rows_dev.index_select(0, sel).cpu().numpy().astype(np.float64)

    phases.start("mux")
    # ---- per-stream overdraft guard + packed mux ------------------------
    from .mux_packed import assemble_stream
    out = []
    for s in range(B):
        n_frames = G_s[s] // 2
        cap_f = cap_s[s]
        sl = slice(int(offs[s]), int(offs[s + 1]))
        stream_bits = 0
        placed_bytes = 0
        for f in range(n_frames):
            g0 = int(offs[s]) + f * 2 * nch
            need = int(p23[g0: g0 + 2 * nch].sum())
            res_now = placed_bytes * 8 - stream_bits
            if need > int(cap_f[f]) + res_now:
                avail = min(max(res_now, 0), 3000)
                bud = int(min(base_s[s][f] + avail // (2 * nch), 3900))
                gi = np.arange(g0, g0 + 2 * nch)
                rh = rows_host(gi)
                for bt in np.unique(bt_all[gi]):
                    m = np.nonzero(bt_all[gi] == bt)[0]
                    ixr, ggr = vloop.inner_rate_rows(
                        rh[m], np.full(len(m), bud, np.int64),
                        sample_rate, int(bt))
                    for j, mi in enumerate(m):
                        i = int(gi[mi])
                        g = encode_granule(ixr[j], int(ggr[j]),
                                           sample_rate, int(bt))
                        row = np.packbits(np.asarray(g.bits.bits, np.uint8))
                        bits_bytes[i] = 0
                        bits_bytes[i, : len(row)] = row
                        meta[i] = (g.part2_3_length, g.big_values,
                                   g.scalefac_compress, g.region0_count,
                                   g.region1_count)
                        tsel_a[i] = g.table_select
                        c1t_a[i] = g.count1table_select
                        gg_a[i] = g.global_gain
                        sbg_a[i] = 0
                        p23[i] = g.part2_3_length
                need = int(p23[g0: g0 + 2 * nch].sum())
            stream_bits += need
            stream_bits = (stream_bits + 7) & ~7
            placed_bytes += int(cap_f[f]) // 8
            excess = placed_bytes - stream_bits // 8 - ReservoirMux.MAX_BACK
            if excess > 0:
                stream_bits += excess * 8
        body = assemble_stream(
            bits_bytes[sl], p23[sl], meta[sl, 1].astype(np.int64),
            gg_a[sl], meta[sl, 2].astype(np.int64), bt_all[sl], tsel_a[sl],
            sbg_a[sl], meta[sl, 3].astype(np.int64),
            meta[sl, 4].astype(np.int64), c1t_a[sl], ms_s[s],
            nch, sr_idx, br_idx, sample_rate, bitrate,
            require_native=on_card)
        if gapless_tag:
            xing_bytes = FrameSizer(sample_rate, bitrate * 1000).next()[0]
            xing = build_xing_frame(nch, sr_idx, br_idx, xing_bytes,
                                    n_frames=n_frames,
                                    n_bytes=len(body) + xing_bytes,
                                    encoder_delay=ENCODER_DELAY,
                                    encoder_padding=encpad_s[s])
            body = xing + body
        out.append(body)
    phases.close()
    if _prof:
        global LAST_PROFILE
        LAST_PROFILE = dict(_ph)
        print('MP3TPU_ENCODE_PROFILE',
              {k: round(v, 3) for k, v in _ph.items()}, flush=True)
    return out
