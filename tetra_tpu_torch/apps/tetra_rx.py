"""tetra-rx style CLI: demodulate and decode TETRA from an IQ capture (port
of tetra_tpu/apps/tetra_rx.py; every flag of the reference, plus --device).

Capability parity with the reference plugin's two operating modes
(main.cpp:184-197):
  mode 0 (decode):  IQ -> demod -> burst sync -> MAC decode -> status lines
                    (+ optional voice PCM to a file)
  mode 1 (netsyms): IQ -> demod -> raw unpacked bits streamed over UDP in the
                    osmo-tetra "NETSYMS" format (tetra-rx compatible,
                    main.cpp:385-414), with the training-sequence monitor.

Input: raw IQ at 36 kHz per channel - a file path (cf32/cs16/cs8/cu8 raw
samples, see --format), or `udp:PORT`
for a live stream into the native ring-buffer runtime - or a wideband capture
with --wideband N (channelized to N x 25 kHz channels).

With --fleet, --voice monitors every call (voice=True: the fleet engine's
voice monitor, every traffic timeslot of every channel, decrypted where
--keystore holds the cell's key) and writes each call's PCM to a file of
its own, the --voice name with .c<channel>.t<timeslot> before its
extension.

Everything on the device runs on --device: the current CUDA device by
default, the CPU only when asked for (--device cpu).  --profile DIR writes
a torch.profiler trace of the decode loop (DIR/tetra_rx.pt.trace.json),
with the fleet receiver's own tetra.* ranges (tetra_tpu_torch.spans).

Usage:
  python -m tetra_tpu_torch.apps.tetra_rx capture.cf32 [--wideband N]
         [--mode 0|1] [--demod fast|ff|exact] [--udp host:port]
         [--voice out.pcm] [--block 4096] [--status-every S] [--device D]
  python -m tetra_tpu_torch.apps.tetra_rx udp:7355 --duration 10
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import sys

import numpy as np

from .. import exact_float32, resolve_device
from .. import params as P
from ..rx.receiver import TetraReceiver
from ..rx import demod as demod_exact
from ..voice.pipeline import VoicePipeline


#: raw IQ sample formats: name -> (numpy dtype, DC offset, scale to ~unit)
IQ_FORMATS = {
    "cf32": (np.complex64, 0.0, 1.0),          # interleaved float32 I/Q
    "cs16": (np.int16, 0.0, 1.0 / 32768.0),    # interleaved int16 (SDR++,
                                               # HackRF captures, ...)
    "cs8": (np.int8, 0.0, 1.0 / 128.0),        # interleaved int8
    "cu8": (np.uint8, 127.5, 1.0 / 127.5),     # offset uint8 (rtl_sdr)
}


def _format_of(path: str, fmt: str | None) -> str:
    """Explicit --format wins; else infer from the file extension
    (.cf32/.fc32/.cs16/.sc16/.cs8/.cu8; anything else = cf32, the
    historical default).  An unrecognized extension that LOOKS like a
    sample-format suffix (e.g. .sc8, .cs12, .cu4) gets a stderr warning
    instead of being silently parsed as float32 garbage."""
    if fmt:
        return fmt
    ext = path.rsplit(".", 1)[-1].lower()
    alias = {"fc32": "cf32", "sc16": "cs16", "raw": "cf32", "iq": "cf32"}
    ext = alias.get(ext, ext)
    if ext in IQ_FORMATS:
        return ext
    import re
    if re.fullmatch(r"[su]?[cif][a-z]?\d{1,2}", ext):
        print(f"warning: unrecognized sample-format extension .{ext}; "
              f"reading {path} as cf32 (use --format to override)",
              file=sys.stderr)
    return "cf32"


def load_iq(path: str, fmt: str | None = None,
            expect_rate: int | None = None) -> np.ndarray:
    """Load an IQ capture as complex64: raw samples in any of IQ_FORMATS,
    or a 2-channel WAV recording (SDR#/SDR++ baseband format: left = I,
    right = Q, s16 or f32 frames).

    The reference consumes an SDR++ VFO stream, so any device SDR++
    supports feeds it; file-based operation here covers the common
    capture formats (rtl_sdr cu8, SDR++/HackRF cs16, GNURadio cf32,
    SDR# baseband WAV).

    expect_rate: required sample rate in Hz (36000 narrowband, N*25000
    wideband).  WAV headers carry the true capture rate; a mismatch
    (e.g. a 2.4 Msps SDR recording fed to the 36 kHz receiver) would
    silently never lock, so it raises with a resample hint instead."""
    if fmt is None and path.lower().endswith(".wav"):
        from scipy.io import wavfile
        wav_rate, data = wavfile.read(path, mmap=True)
        if expect_rate is not None and int(wav_rate) != int(expect_rate):
            raise ValueError(
                f"{path}: capture is {wav_rate} Hz but the receiver expects "
                f"{expect_rate} Hz - resample first, or use --wideband N "
                f"with N*25000 matching the capture rate")
        if data.ndim != 2 or data.shape[1] != 2:
            raise ValueError(f"{path}: IQ WAV must have 2 channels")
        if data.dtype == np.int16:
            data = data.astype(np.float32) / 32768.0
        elif data.dtype == np.int32:
            data = data.astype(np.float32) / 2147483648.0
        elif data.dtype == np.uint8:
            data = (data.astype(np.float32) - 127.5) / 127.5
        else:
            data = data.astype(np.float32)
        return (data[:, 0] + 1j * data[:, 1]).astype(np.complex64)
    name = _format_of(path, fmt)
    dtype, off, scale = IQ_FORMATS[name]
    if name == "cf32":
        return np.fromfile(path, np.complex64)
    raw = np.fromfile(path, dtype).astype(np.float32)
    raw = (raw - np.float32(off)) * np.float32(scale)
    if len(raw) & 1:
        raw = raw[:-1]
    return (raw[0::2] + 1j * raw[1::2]).astype(np.complex64)


def iter_blocks(args):
    """Yield (C, block) complex64 blocks from a file or live UDP stream
    (the channelizer and resampler run on args.device).

    In fused-wideband mode (args._fused: --wideband with the fast chain,
    decode mode) raw 1-D wideband chunks are yielded instead and the
    receiver runs the one-program cascade (TetraReceiver.process_wideband)
    -- which also makes live udp: wideband input work."""
    fused = getattr(args, "_fused", False)
    if args.input.startswith("udp:"):
        from ..runtime.iq_stream import IqStream
        stream = IqStream()
        stream.open_udp(int(args.input.split(":", 1)[1]))
        import time as _time
        t_end = _time.time() + args.duration
        while _time.time() < t_end:
            blk = stream.read(args.block, timeout_ms=1000)
            if len(blk) == args.block:
                yield blk if fused else blk[None, :]
        stream.stop()
        return
    iq = load_iq(args.input, getattr(args, "format", None),
                 expect_rate=(args.wideband * 25000 if args.wideband
                              else P.SAMPLE_RATE))
    if fused:
        chunk = 6400 * (args.wideband // 2)  # one cascade advance
        for i in range(0, len(iq), chunk):
            yield iq[i:i + chunk]
        return
    if args.wideband:
        from ..parallel import channelizer as CH
        ch = CH.channelize(iq, args.wideband, args.device)
        iq = CH.resample_50_to_36(ch, args.device)
    else:
        iq = iq[None, :]
    for i in range(iq.shape[1] // args.block):
        yield iq[:, i * args.block:(i + 1) * args.block]


class NetsymsStreamer:
    """Mode-1 UDP bit streamer + training sequence monitor
    (main.cpp:385-414): sends raw unpacked bits, tracks whether any known
    training sequence appeared within the last 2048 symbols."""

    TS_EXPIRE = 2048

    def __init__(self, host: str, port: int):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.addr = (host, port)
        self.window = np.zeros(0, np.uint8)
        self.since_found = self.TS_EXPIRE
        self.seqs = [P.TRAIN_SEQS[i] for i in range(5)] + [
            P.TRAIN_X45, P.TRAIN_N33, P.TRAIN_P33]

    def send(self, bits: np.ndarray):
        self.sock.sendto(bits.astype(np.uint8).tobytes(), self.addr)
        buf = np.concatenate([self.window, bits])
        found = False
        for seq in self.seqs:
            L = len(seq)
            if len(buf) >= L:
                win = np.lib.stride_tricks.sliding_window_view(buf, L)
                if (win == seq).all(axis=1).any():
                    found = True
                    break
        if found:
            self.since_found = 0
        else:
            self.since_found += len(bits) // 2
        self.window = buf[-45:]

    @property
    def ts_found(self) -> bool:
        return self.since_found < self.TS_EXPIRE


def _ascii_constellation(re, im, size=17, half=1.8):
    """Density plot of the post-Costas constellation (the reference's
    ImGui constellation diagram, gui_widgets/main.cpp:376-383)."""
    rows = [[" "] * size for _ in range(size)]
    shades = " .:*#@"
    if len(re):
        xi = np.clip(((re + half) / (2 * half) * size).astype(int), 0, size - 1)
        yi = np.clip(((half - im) / (2 * half) * size).astype(int), 0, size - 1)
        grid = np.zeros((size, size), int)
        np.add.at(grid, (yi, xi), 1)
        mx = max(1, grid.max())
        for y in range(size):
            for x in range(size):
                if grid[y, x]:
                    rows[y][x] = shades[min(5, 1 + grid[y, x] * 4 // mx)]
    return ["      |" + "".join(r) + "|" for r in rows]


def _lamp(ok: bool) -> str:
    """ANSI equivalent of the reference's BoxIndicator colored lamp
    (gui_widgets.h:16-33): green/red dot."""
    return "\x1b[32m●\x1b[0m" if ok else "\x1b[31m●\x1b[0m"


def _quality_meter(q: float, width: int = 12) -> str:
    """ANSI equivalent of SigQualityMeter (gui_widgets.h:35-66): a bar of
    signal quality derived from the mean |phase error| q (0 = perfect,
    SYNC_QUALITY_THRESHOLD = the sync gate, ~0.9 = random)."""
    frac = max(0.0, min(1.0, 1.0 - q / (2 * P.SYNC_QUALITY_THRESHOLD)))
    fill = int(round(frac * width))
    color = "\x1b[32m" if q < P.SYNC_QUALITY_THRESHOLD else "\x1b[31m"
    return (color + "█" * fill + "\x1b[0m" + "░" * (width - fill))


def _render_dashboard(rx, C, constellation=True, voice=None):
    """Terminal panel with the reference status GUI's field set
    (menuHandler, main.cpp:199-374) rendered from DisplayState, with ANSI
    lamp/meter widgets standing in for BoxIndicator/SigQualityMeter."""
    lines = ["\x1b[2J\x1b[H=== tetra_tpu receiver status ==="]
    if voice is not None:
        cal = voice.calibration_status()
        vline = (f"voice: {voice.slots_decoded} slots, "
                 f"{voice.bad_frames} bad")
        if cal is not None:
            vline += (f"  codec-cal {cal['full']}"
                      + (f" [{cal['profile']}]" if cal["profile"] else "")
                      + (f" half={cal['half']}"
                         if cal["half"] != "idle" else ""))
        lines.append(vline)
    tc_names = {0: "-", 1: "CTRL", 2: "NDB2", 3: "SYNC", 4: "VOICE"}
    for c in range(C):
        d = rx.display(c)
        lock = "LOCK" if rx.locked(c) else "----"
        q = rx.sym_quality[c]
        slots = "/".join(tc_names.get(t, "?") for t in d.timeslot_content)
        lines.append(
            f"ch{c:3d} {_lamp(rx.locked(c))}[{lock}] "
            f"|{_quality_meter(q)}| q={q:.2f} "
            f"net {d.mcc}/{d.mnc} cc {d.cc}  "
            f"t {d.curr_hyperframe}:{d.curr_multiframe:02d}/{d.curr_frame:02d}  "
            f"dl {d.dl_freq/1e6:9.4f} MHz ul {d.ul_freq/1e6:9.4f} MHz")
        lines.append(
            f"      slots [{slots}]  usage {d.dl_usage}/{d.ul_usage}  "
            f"access {d.access1_code}{d.access1}/{d.access2_code}{d.access2}  "
            f"crc {_lamp(not d.last_crc_fail)} "
            f"{rx.crc_counts(c)[0]}/{rx.crc_counts(c)[1]}")
        flags = [n for n in ("voice_service", "normal_mode", "air_encryption",
                             "sndcp_data", "circuit_data", "advanced_link")
                 if getattr(d, n)]
        if flags:
            lines.append(f"      services: {' '.join(flags)}")
    if constellation:
        # constellation of the first locked channel (or channel 0)
        c = next((c for c in range(C) if rx.locked(c)), 0)
        re, im = rx.constellation(c)
        lines.append(f"      constellation ch{c} ({len(re)} syms):")
        lines.extend(_ascii_constellation(re, im))
    print("\n".join(lines), flush=True)


def _format_event(e) -> str | None:
    """One console line per upper-MAC event (the decoded-PDU dump the
    reference prints from rx_tmv_unitdata_ind / rx_resrc / rx_bcast)."""
    kind = e[0]
    if kind == "resource":
        rsd = e[2]
        if rsd.addr.type == 0:  # NULL address filler
            return None
        extra = ""
        if rsd.macpdu_length == -2:
            extra = " 2nd-half-stolen"
        elif rsd.macpdu_length == -1:
            extra = " start-frag"
        if rsd.is_encrypted:
            extra += f" encrypted(mode={rsd.encryption_mode})"
        return f"MAC-RESOURCE ssi=0x{rsd.addr.ssi:06x}{extra}"
    if kind == "sysinfo":
        sid = e[2]
        return f"SYSINFO dl={sid.dl_freq_hz/1e6:.4f}MHz la={sid.la}"
    if kind == "llc":
        llc, tl = e[2], e[3]
        if tl is None:
            return f"LLC {llc.name}"
        return f"LLC {llc.name} {tl.pdisc_name} {tl.pdu_name}"
    if kind == "suppl":
        return "MAC-SUPPLEMENTARY"
    if kind == "tm_sdu_reassembled":
        return f"TM-SDU reassembled ({len(e[2])} bits)"
    return None


class CallPcm:
    """The fleet voice monitor's PCM, each call (channel, timeslot) into a
    file of its own: `path` with .c<channel>.t<timeslot> before its
    extension, raw s16 8 kHz, or a WAV where `path` ends .wav."""

    def __init__(self, path: str):
        self.stem, self.ext = os.path.splitext(path)
        self.files: dict = {}

    def _file(self, c: int, tn: int):
        f = self.files.get((c, tn))
        if f is None:
            name = f"{self.stem}.c{c}.t{tn}{self.ext}"
            if self.ext == ".wav":
                import wave
                f = wave.open(name, "wb")
                f.setnchannels(1)
                f.setsampwidth(2)
                f.setframerate(8000)
            else:
                f = open(name, "wb")
            self.files[(c, tn)] = f
        return f

    def write(self, blocks: list) -> None:
        """VoiceBlocks (voice.monitor), rows in time order within a call."""
        for b in blocks:
            key = b.carrier * 4 + b.timeslot - 1
            order = np.argsort(key, kind="stable")
            calls, starts = np.unique(key[order], return_index=True)
            for k, rows in zip(calls, np.split(order, starts[1:])):
                f = self._file(int(k) // 4, int(k) % 4 + 1)
                data = np.ascontiguousarray(b.pcm[rows]).tobytes()
                if hasattr(f, "writeframes"):
                    f.writeframes(data)
                else:
                    f.write(data)

    def close(self) -> None:
        for f in self.files.values():
            f.close()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("input", help="raw IQ file (see --format) or udp:PORT")
    ap.add_argument("--format", choices=sorted(IQ_FORMATS), default=None,
                    help="raw sample format of the input file (default: "
                         "inferred from the extension, else cf32)")
    ap.add_argument("--wideband", type=int, default=0, metavar="N",
                    help="input is a wideband capture at N*25 kHz; "
                         "channelize to N channels")
    ap.add_argument("--mode", type=int, default=0, choices=(0, 1))
    ap.add_argument("--udp", default="localhost:8355")
    ap.add_argument("--voice", default=None, help="write voice audio: raw s16 8k PCM, or a playable WAV if the name ends .wav")
    ap.add_argument("--audio-rate", type=int, default=0, metavar="HZ",
                    help="with --voice: resample to HZ float32 stereo "
                         "(reference audio tail, main.cpp:96-103) instead "
                         "of raw s16 8k")
    ap.add_argument("--block", type=int, default=4096)
    ap.add_argument("--status-every", type=float, default=1.0,
                    help="seconds of air time between status lines")
    ap.add_argument("--demod", choices=("fast", "ff", "exact"), default="fast")
    ap.add_argument("--fleet", action="store_true",
                    help="native fleet engine: whole bit pipeline (burst "
                         "sync + MAC + display) in C++ around batched "
                         "device FEC -- the production path at scale "
                         "(implies no event log; with --voice, every "
                         "call's PCM to its own file, decrypted with "
                         "--keystore)")
    ap.add_argument("--link-profile", choices=("tunnel", "pcie"),
                    default="tunnel",
                    help="with --fleet: pcie (a locally attached card) "
                         "double-buffers the superblocks when --wb-k > 1 "
                         "(the device step on a side CUDA stream while the "
                         "host decodes the previous one; the summary then "
                         "lacks the last superblock, as in the JAX CLI) "
                         "and puts fleet workers on every core; tunnel "
                         "runs superblocks in turn with cores-1 workers")
    ap.add_argument("--wb-k", type=int, default=1, metavar="K",
                    help="with --fleet --wideband: superblock depth "
                         "(demod cycles per device dispatch+fetch; "
                         "bench_e2e's best is 32)")
    ap.add_argument("--mac-workers", type=int, default=0, metavar="N",
                    help="shard host MAC dispatch over N worker processes "
                         "(rx.hostpool; for 100+ channel configs)")
    ap.add_argument("--keystore", default=None,
                    help="crypto keystore file (reference text format); "
                         "with --fleet, the voice monitor's keys (give "
                         "--voice too)")
    ap.add_argument("--duration", type=float, default=10.0,
                    help="seconds to run for live (udp:) input")
    ap.add_argument("-v", "--verbose", action="store_true",
                    help="print each decoded PDU (the reference's console "
                         "dump; rx_tmv_unitdata_ind et al.)")
    ap.add_argument("--metrics", default=None, metavar="JSONL",
                    help="append per-interval structured metrics (the "
                         "tetra_display_state field set) to this file")
    ap.add_argument("--dashboard", action="store_true",
                    help="render a refreshing terminal status panel (the "
                         "reference GUI's field set, main.cpp:199-374)")
    ap.add_argument("--state", default=None, metavar="NPZ",
                    help="receiver checkpoint: loaded if present, saved on "
                         "exit (resume decoding without re-acquisition)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="capture a torch.profiler device+host trace of "
                         "the decode loop into DIR/tetra_rx.pt.trace.json "
                         "(view with Perfetto or chrome://tracing); with "
                         "--fleet it holds the receiver's tetra.* ranges "
                         "(superblock, step, frontend, demod, fetch, "
                         "engine, fec, ...) around the work they launch")
    ap.add_argument("--codec-profile", default=None, metavar="JSON",
                    help="voice channel-codec profile (CRC generators + "
                         "5.5.3 matrix convention; voice.channel.load_profile"
                         " format) -- drop in real ETSI constants with zero "
                         "code change")
    ap.add_argument("--codec-tables", default=None, metavar="NPZ",
                    help="runtime ACELP quantizer tables (LSF split-VQ + "
                         "gain codebooks; voice.acelp.load_codec_tables "
                         "format)")
    ap.add_argument("--calibrate-codec", action="store_true",
                    help="with --voice: auto-resolve the codec CRC/"
                         "interleave conventions on live clear traffic "
                         "(voice.channel.ProfileCalibrator); progress is "
                         "logged and surfaced in --metrics/--dashboard as "
                         "calibration searching/resolved/exhausted")
    ap.add_argument("--config", default=None, metavar="JSON",
                    help="per-instance settings file: loaded as defaults, "
                         "saved back on exit (the plugin's config "
                         "persistence; main.cpp config load/save)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA device; "
                         "'cpu' runs everything on the host)")
    # two-pass parse so a --config file supplies defaults that explicit
    # flags still override
    pre, _ = ap.parse_known_args(argv)
    if pre.config:
        if os.path.exists(pre.config):
            with open(pre.config) as f:
                saved = json.load(f)
            ap.set_defaults(**{k: v for k, v in saved.items()
                               if k in {a.dest for a in ap._actions}})
    args = ap.parse_args(argv)
    if args.config:
        with open(args.config, "w") as f:
            json.dump({"mode": args.mode, "udp": args.udp,
                       "demod": args.demod, "block": args.block,
                       "wideband": args.wideband,
                       "status_every": args.status_every}, f, indent=1)
    args.device = resolve_device(args.device)
    exact_float32()

    if args.codec_profile:
        from ..voice.channel import load_profile
        prof = load_profile(args.codec_profile)
        print(f"# codec profile: {prof.name}", flush=True)
    if args.codec_tables:
        from ..voice.acelp import load_codec_tables
        load_codec_tables(args.codec_tables)
        print(f"# codec tables loaded: {args.codec_tables}", flush=True)

    # fused-wideband: channelize+resample+demod as ONE device program per
    # block inside the receiver (streaming, live-input capable); the split
    # host path remains for the ff/exact chains and mode 1
    args._fused = bool(args.wideband) and args.demod == "fast" \
        and args.mode == 0
    live = args.input.startswith("udp:")
    blocks = None if live else list(iter_blocks(args))

    if args.mode == 1:
        host, port = args.udp.rsplit(":", 1)
        streamer = NetsymsStreamer(host, int(port))
        from ..rx import demod_fast
        mod = demod_fast if args.demod == "fast" else demod_exact
        state = None
        for blk in (blocks or iter_blocks(args)):
            if state is None:
                state = mod.demod_init(blk.shape[0], args.device)
            state, outs = mod.demod_block(state, blk)
            d = outs["dibits"][0].cpu().numpy()
            v = outs["valid"][0].cpu().numpy()
            bits = demod_exact.dibits_to_bits(d[v])
            streamer.send(bits)
        print(json.dumps({"mode": 1, "sent_bits": True,
                          "ts_found": streamer.ts_found}))
        return 0

    pooled = args.mac_workers > 0
    if args.fleet and args.keystore and not args.voice:
        raise SystemExit("--fleet takes --keystore for its voice monitor: "
                         "give --voice too")
    if args.fleet and args.voice and args.audio_rate:
        raise SystemExit("--fleet --voice writes each call's 8 kHz PCM; "
                         "--audio-rate is for the per-channel receivers")
    monitor = bool(args.fleet and args.voice)
    voice = VoicePipeline(calibrate=args.calibrate_codec,
                          device=args.device) \
        if (args.voice and not pooled and not monitor) else None
    if voice is not None and voice.calibrator is not None:
        voice.calibrator.log = lambda msg: print(f"[voice] {msg}")
    rx = None
    status_blocks = max(1, int(args.status_every * P.SAMPLE_RATE / args.block))
    if args._fused:  # fused blocks advance 6400*hop wideband samples
        status_blocks = max(1, int(args.status_every * 25_000 / 6400))
    audio_out = None
    if args.voice and args.audio_rate:
        from ..voice.audio_out import AudioOutput
        audio_out = AudioOutput(out_rate=args.audio_rate,
                                device=args.device)
    pcm_out = None
    if monitor:
        pcm_out = CallPcm(args.voice)
    elif args.voice:
        if args.voice.endswith(".wav"):
            # playable WAV container: 8 kHz mono s16, or with --audio-rate
            # the resampled stereo tail converted back to s16
            import wave as _wave
            pcm_out = _wave.open(args.voice, "wb")
            if audio_out is not None:
                pcm_out.setnchannels(2)
                pcm_out.setframerate(args.audio_rate)
            else:
                pcm_out.setnchannels(1)
                pcm_out.setframerate(8000)
            pcm_out.setsampwidth(2)
        else:
            pcm_out = open(args.voice, "wb")

    def _write_pcm(pcm):
        if audio_out is not None:
            rendered = audio_out.render(pcm)      # float32 interleaved stereo
            if hasattr(pcm_out, "writeframes"):
                s16 = np.clip(rendered * 32767.0, -32768, 32767)
                pcm_out.writeframes(s16.astype(np.int16).tobytes())
            else:
                rendered.tofile(pcm_out)
        elif hasattr(pcm_out, "writeframes"):
            pcm_out.writeframes(np.asarray(pcm, np.int16).tobytes())
        else:
            pcm.tofile(pcm_out)
    C = 1
    wb = args.wideband if args._fused else 0
    prof = None
    if args.profile:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if args.device.type == "cuda" else [])
        prof = profile(activities=acts)
        prof.start()
    try:
        for i, blk in enumerate(blocks or iter_blocks(args)):
            if rx is None:
                C = args.wideband if args._fused else blk.shape[0]
                # the event log's only CLI consumer is -v: leave it off
                # otherwise (headless decode skips event/LLC/MLE bookkeeping
                # and the log cannot grow unboundedly on long captures)
                if pooled:
                    rx = TetraReceiver(C, mode=args.demod,
                                       mac_workers=args.mac_workers,
                                       voice=bool(args.voice),
                                       keystore=args.keystore,
                                       events=args.verbose, wideband=wb,
                                       device=args.device)
                elif args.fleet:
                    # production fleet path: whole bit pipeline in the
                    # native engine around batched device FEC, superblock
                    # depth wb_k (the bench_e2e configuration)
                    if args.verbose:
                        print("# --fleet: event log unavailable "
                              "(native dispatch)", flush=True)
                    rx = TetraReceiver(C, mode=args.demod,
                                       events=False, wideband=wb,
                                       fleet=True, wb_k=args.wb_k,
                                       link_profile=args.link_profile,
                                       voice=monitor, keystore=args.keystore,
                                       device=args.device)
                else:
                    rx = TetraReceiver(C, voice_cb=voice, mode=args.demod,
                                       events=args.verbose, wideband=wb,
                                       device=args.device)
                if args.keystore and not pooled and not args.fleet:
                    from ..crypto.state import CryptoState, KeyStore
                    for m in rx.mac:
                        m.upper.crypto_state = CryptoState(
                            store=KeyStore.load(args.keystore))
                    if voice is not None and rx.mac:
                        # encrypted-voice decode (single shared pipeline:
                        # channel 0's crypto state)
                        voice.crypto_state = rx.mac[0].upper.crypto_state
                if args.state and not pooled:
                    if os.path.exists(args.state):
                        rx.load_state(args.state)
            if args._fused:
                rx.process_wideband(blk)
            else:
                rx.process(blk)
            if args.verbose:
                if i == 0:
                    ev_seen = [0] * C
                for c in range(C):
                    events = (rx.pool.views[c].events if pooled
                              else rx.mac[c].upper.events)
                    for e in events[ev_seen[c]:]:
                        line = _format_event(e)
                        if line:
                            print(f"[ch {c}] {e[1]} {line}")
                    ev_seen[c] = len(events)
            if monitor:
                pcm_out.write(rx.take_voice())
            elif pcm_out is not None:
                pcm = (rx.pool.take_audio() if pooled
                       else voice.take_audio() if voice is not None
                       else None)
                if pcm is not None and len(pcm):
                    _write_pcm(pcm)
            if args.metrics and (i + 1) % status_blocks == 0:
                import time as _time
                with open(args.metrics, "a") as mf:
                    for c in range(C):
                        oks, fails = rx.crc_counts(c)
                        rec = dict(ts=_time.time(), channel=c,
                                   locked=rx.locked(c),
                                   quality=float(rx.sym_quality[c]),
                                   crc_ok=oks, crc_fail=fails,
                                   **rx.display(c).as_dict())
                        mf.write(json.dumps(rec) + "\n")
                    if voice is not None:
                        vrec = dict(ts=_time.time(), record="voice",
                                    slots=voice.slots_decoded,
                                    bad_frames=voice.bad_frames)
                        cal = voice.calibration_status()
                        if cal is not None:
                            vrec["calibration"] = cal
                        mf.write(json.dumps(vrec) + "\n")
            if args.dashboard and (i + 1) % status_blocks == 0:
                _render_dashboard(rx, C, voice=voice)
            elif (i + 1) % status_blocks == 0:
                for c in range(C):
                    d = rx.display(c)
                    if rx.locked(c):
                        print(f"[ch {c}] LOCK mcc={d.mcc} mnc={d.mnc} cc={d.cc} "
                              f"time={d.curr_multiframe}/{d.curr_frame} "
                              f"dl={d.dl_freq/1e6:.4f}MHz "
                              f"usage={d.dl_usage}/{d.ul_usage} "
                              f"slots={d.timeslot_content} "
                              f"crc={rx.crc_counts(c)[0]}/{rx.crc_counts(c)[1]} "
                              f"q={rx.sym_quality[c]:.2f}")
                    else:
                        print(f"[ch {c}] UNLOCKED q={rx.sym_quality[c]:.2f}")
    finally:
        if prof is not None:
            # always stop and write the trace, even when the decode loop
            # raises (KeyboardInterrupt on live udp: streams included)
            prof.stop()
            os.makedirs(args.profile, exist_ok=True)
            prof.export_chrome_trace(
                os.path.join(args.profile, "tetra_rx.pt.trace.json"))
    if pcm_out:
        pcm_out.close()
    if args.state and rx is not None and not pooled:
        rx.save_state(args.state)
    # final summary as one JSON line
    summary = []
    for c in range(C):
        d = rx.display(c)
        oks, fails = rx.crc_counts(c)
        summary.append(dict(channel=c, locked=rx.locked(c), mcc=d.mcc,
                            mnc=d.mnc, cc=d.cc, crc_ok=oks, crc_fail=fails))
    print(json.dumps(summary))
    if pooled:
        rx.pool.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
