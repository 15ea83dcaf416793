"""Plain reference of the voice path: the speech channel decoding of one
traffic slot or one surviving half, TEA1 decryption of codec frames, and
ACELP synthesis of a call's codec frames to 8 kHz s16 PCM.

Plain NumPy in float32 (float64 where the codec itself computes in
double), nothing of the program.  Its copies: tetra_bench/reference/voice.py
for the benchmark and tests/plain_voice.py for the tests, byte-equal.

Speech channel decoding (EN 300 395-2 clause 5, as the program's
voice/channel.py implements it, with the benchmark's air as its encoder,
air/speech.py): the 432 type-4 bits of a slot, as soft values (+1 ~ bit
0, -1 ~ bit 1), are de-interleaved from the 24 x 18 matrix, class 0 (102)
sliced hard, class 1 (168 coded) de-punctured 8/12 and Viterbi-decoded to
112 bits by the rate-1/3 K=5 mother code from state 0 and traced back
from the best end state, class 2 (162 coded) de-punctured 8/18 to 72
steps, traced back from state 0, its last 12 bits the CRC-8 and the tail;
the bits go back to the two codec frames by the class position tables.
A surviving half: 12 x 18, 51 + 84 (8/12, 56 steps) + 80 (8/17, 38
steps: 30 bits, CRC-4, tail) + 1 fill.  Departures from the standard are
the program's, recorded in PARITY.md: the class-0 table made a
partition, the matrix interleaver's orientation, the CRC generators
(X^8+X^4+X^3+X^2+1, X^4+X+1, init 0) and the half block's layout.

TEA1 (EN 300 392-7): the air's frozen generator (air/cipher.py); a slot's
IV from its (mn, fn, tn) and the cell's hyperframe; keystream bits 0-273
over a full slot's two frames, bits 137-273 over a half's surviving
frame.

ACELP synthesis: the program's own codec (csrc/host/acelp_codec.cpp,
tetra_acelp_decode_frame, its parametric quantizers), equation for
equation: the predictive LSF quantizer and its ordering, LSF -> LPC in
float64, the half-sample adaptive codebook, the 4-pulse algebraic
codebook, the log-domain gain predictor, the excitation's RMS guard, the
10th-order synthesis filter, the pole-zero postfilter with its adaptive
tilt and AGC, the 100 Hz high-pass and the s16 output.  It departs from
the codec in one way, for the run time of a check over hundreds of calls:
the calls run side by side as columns of one array (column b is call b's
decoder; no value crosses columns, and each column's operations are the
codec's, in its order).  Every float32 operation rounds as the codec's
does; cos and exp are the C library's cosf and expf, the functions the
codec calls (NumPy's own round otherwise in 1-40% of cases, and the
filters' resonances carry such a difference on for hundreds of frames).
The dtype is a parameter: the control runs it in float16.
"""

from __future__ import annotations

import numpy as np

from tetra_bench.air import cipher, speech

FRAME_BITS = 137
FRAME = 240
SUB = 60
ORDER = 10
LAG2_MIN, LAG2_MAX = 40, 295
HIST = 147 + 4                       # excitation history: PITCH_MAX + pad
LSF_MEAN = (0.24, 0.47, 0.81, 1.12, 1.44, 1.78, 2.09, 2.40, 2.68, 2.94)
LSF_BITS = (3, 3, 2, 3, 3, 3, 2, 2, 2, 3)
LSF_PRED, LSF_SPAN, LSF_GAP = 0.65, 0.25, 0.035
HALF_TAPS = (-0.00732, 0.03248, -0.13735, 0.61219,
             0.61219, -0.13735, 0.03248, -0.00732)
HP_B = (0.9446, -1.8892, 0.9446)
HP_A = (-1.8861, 0.8923)


def _float32() -> None:
    """Hold TF32 off: the reference computes in NumPy, so no TF32 product
    or convolution can enter it, and none may where torch is added."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# -- speech channel decoding -------------------------------------------------

def _puncture_idx(punct: tuple, out_len: int) -> np.ndarray:
    pt, t, period = punct
    j = np.arange(1, out_len + 1)
    blk = (j - 1) // t
    return period * blk + np.asarray(pt)[j - t * blk] - 1


def _mother_out(state: int, bit: int) -> np.ndarray:
    """The mother code's three output bits leaving `state` (bit i = the
    input i + 1 steps back) on input `bit`."""
    reg = np.array([bit] + [(state >> i) & 1 for i in range(4)], np.int64)
    return (speech.TCH_POLYS.astype(np.int64) @ reg) % 2


def viterbi(soft: np.ndarray, truncate: bool) -> np.ndarray:
    """(T, 3) soft mother symbols (0 where punctured) -> T bits: the path
    from state 0, ending on the best state (truncate) or on state 0."""
    T = len(soft)
    m = np.full(16, -1e9, np.float32)
    m[0] = 0.0
    took = np.zeros((T, 16), bool)
    for t in range(T):
        new = np.empty(16, np.float32)
        for ns in range(16):
            b = ns & 1
            c = [m[p] + np.float32((soft[t] * (1.0 - 2.0 * _mother_out(p, b))
                                    .astype(np.float32)).sum())
                 for p in (ns >> 1, (ns >> 1) + 8)]
            took[t, ns] = c[1] > c[0]
            new[ns] = c[1] if took[t, ns] else c[0]
        m = new - new.max()
    state = int(np.argmax(m)) if truncate else 0
    bits = np.zeros(T, np.uint8)
    for t in range(T - 1, -1, -1):
        bits[t] = state & 1
        state = (state >> 1) + (8 if took[t, state] else 0)
    return bits


def _decode(soft, n_info, punct, truncate):
    _float32()
    mother = np.zeros(3 * n_info, np.float32)
    mother[_puncture_idx(punct, len(soft))] = soft
    return viterbi(mother.reshape(n_info, 3), truncate)


def _crc_ok(bits: np.ndarray, n: int, poly: int) -> bool:
    k = len(bits) - n
    return bool((speech._crc(bits[:k], n, poly) == bits[k:]).all())


def decode_slot(type4) -> tuple[np.ndarray, bool]:
    """One traffic slot's 432 type-4 bits, as soft values -> (frames (2,
    137) uint8, bad frame)."""
    x = np.zeros(432, np.float32)
    x[speech._PERM_SLOT] = np.asarray(type4, np.float32)
    c0 = (x[:102] < 0).astype(np.uint8)
    c1 = _decode(x[102:270], 112, speech.PUNCT_8_12, True)
    c2 = _decode(x[270:], 72, speech.PUNCT_8_18, False)
    frames = np.zeros((2, FRAME_BITS), np.uint8)
    for cls, bits in ((speech.CLASS0, c0), (speech.CLASS1, c1),
                      (speech.CLASS2, c2[:60])):
        pairs = bits.reshape(-1, 2)
        frames[0, cls - 1] = pairs[:, 0]
        frames[1, cls - 1] = pairs[:, 1]
    return frames, not _crc_ok(c2[:68], 8, speech.CRC8_POLY)


def decode_half(type4) -> tuple[np.ndarray, bool]:
    """The surviving half's 216 type-4 bits, as soft values -> (frame
    (137,) uint8, bad frame)."""
    x = np.zeros(216, np.float32)
    x[speech._PERM_HALF] = np.asarray(type4, np.float32)
    c0 = (x[:51] < 0).astype(np.uint8)
    c1 = _decode(x[51:135], 56, speech.PUNCT_8_12, True)
    c2 = _decode(x[135:215], 38, speech.PUNCT_8_17, False)
    frame = np.zeros(FRAME_BITS, np.uint8)
    for cls, bits in ((speech.CLASS0, c0), (speech.CLASS1, c1),
                      (speech.CLASS2, c2[:30])):
        frame[cls - 1] = bits
    return frame, not _crc_ok(c2[:34], 4, speech.CRC4_POLY)


# -- TEA1 --------------------------------------------------------------------

def cell_key(main_carrier: int, la: int, cc: int, cck: bytes) -> bytes:
    """The 80-bit encryption key of a cell from its common cipher key."""
    return cipher.tb5(main_carrier, la, cc, cck)


def decrypt(frames: np.ndarray, mn: int, fn: int, tn: int, hn: int,
            eck: bytes, half: bool = False) -> np.ndarray:
    """A slot's (2, 137) codec frames XOR its TEA1 keystream (bits 0-273;
    a half's surviving frame 2 takes bits 137-273 alone)."""
    ks = cipher.keystream_bits(cipher.build_iv(mn, fn, tn, hn), eck,
                               2 * FRAME_BITS)[0].reshape(2, FRAME_BITS)
    out = np.array(frames, np.uint8).reshape(2, FRAME_BITS)
    out[1] ^= ks[1]
    if not half:
        out[0] ^= ks[0]
    return out


# -- ACELP synthesis ---------------------------------------------------------

def _libm():
    import ctypes
    import ctypes.util
    lib = ctypes.CDLL(ctypes.util.find_library("m") or "libm.so.6")
    for name in ("cosf", "expf"):
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_float, [ctypes.c_float]
    return lib


_LIBM = _libm()


def _unary(x: np.ndarray, c_fn, np_fn) -> np.ndarray:
    """c_fn of each float32 value (the C library's, as the codec calls it,
    once a distinct value), or np_fn in any other dtype."""
    if x.dtype != np.float32:
        return np_fn(x)
    u, inv = np.unique(x, return_inverse=True)
    return np.array([c_fn(float(v)) for v in u], np.float32)[
        inv.reshape(x.shape)]


def _cos(x):
    return _unary(x, _LIBM.cosf, np.cos)


def _exp(x):
    return _unary(x, _LIBM.expf, np.exp)


def _take(bits: np.ndarray, pos: int, n: int) -> np.ndarray:
    return bits[:, pos:pos + n].astype(np.int64) @ (
        1 << np.arange(n - 1, -1, -1, dtype=np.int64))


def lsf_to_lpc(lsf: np.ndarray) -> np.ndarray:
    """(B, 10) LSFs -> (B, 10) LPC coefficients, in float64 as the codec
    computes them (the cosines in the LSFs' own precision, as the codec's
    std::cos of a float): A(z) = [P(z)(1 + z^-1) + Q(z)(1 - z^-1)] / 2."""
    B = len(lsf)
    polys = []
    for off in (0, 1):
        c = -2.0 * _cos(lsf[:, off::2]).astype(np.float64)
        poly = np.zeros((B, 16))
        poly[:, 0] = 1.0
        n = 1
        for i in range(5):
            nxt = np.zeros((B, 16))
            for j in range(n):
                nxt[:, j] += poly[:, j]
                nxt[:, j + 1] += c[:, i] * poly[:, j]
                nxt[:, j + 2] += poly[:, j]
            poly, n = nxt, n + 2
        polys.append(poly)
    p, q = polys
    pf = p[:, 1:11] + p[:, 0:10]
    qf = q[:, 1:11] - q[:, 0:10]
    return 0.5 * (pf + qf)


def _all_pole(x: np.ndarray, a: np.ndarray, mem: np.ndarray) -> np.ndarray:
    """y[i] = x[i] - a[0] y[i-1] - ... - a[9] y[i-10], subtracted in that
    order, over (n, B) x with the memory mem (newest first)."""
    n = len(x)
    y = np.concatenate([mem[::-1], np.empty_like(x)])
    ar = a[::-1]
    for i in range(n):
        prod = ar * y[i:i + ORDER]
        v = x[i].copy()
        for j in range(ORDER - 1, -1, -1):
            v -= prod[j]
        y[ORDER + i] = v
    return y[ORDER:]


class Synth:
    """ACELP decoders of `calls` calls, side by side (column b is call b),
    in `dtype`: frame() takes each call's next 137-bit frame.  Arrays are
    time by call, so a sample of every call is one row."""

    def __init__(self, calls: int, dtype=np.float32):
        _float32()
        self.dt = dt = np.dtype(dtype)
        B = calls
        self.lsf_prev = np.tile(np.asarray(LSF_MEAN, dt)[:, None], (1, B))
        self.mem_syn = np.zeros((ORDER, B), dt)   # newest first
        self.exc = np.zeros((HIST + FRAME, B), dt)
        self.pf_num = np.zeros((ORDER, B), dt)
        self.pf_den = np.zeros((ORDER, B), dt)
        self.tilt = np.zeros(B, dt)
        self.agc = np.ones(B, dt)
        self.hp = np.zeros((4, B), dt)            # x1, x2, y1, y2
        self.prev_gp = np.zeros(B, dt)
        self.log_gc = np.full(B, 5.5, dt)
        self.prev_lag2 = np.full(B, 120, np.int64)

    _STATE = ("lsf_prev", "mem_syn", "exc", "pf_num", "pf_den", "tilt",
              "agc", "hp", "prev_gp", "log_gc", "prev_lag2")

    def frame(self, bits: np.ndarray, bfi: np.ndarray,
              active: np.ndarray | None = None) -> np.ndarray:
        """(B, 137) frames and (B,) bad-frame flags -> (B, 240) int16; the
        columns not `active` keep their state (their output is void)."""
        before = {k: getattr(self, k).copy() for k in self._STATE} \
            if active is not None else None
        out = self._frame(np.asarray(bits, np.uint8), np.asarray(bfi, bool))
        if before is not None:
            keep = ~np.asarray(active, bool)
            for k, old in before.items():
                getattr(self, k)[..., keep] = old[..., keep]
        return out.T

    def _frame(self, bits, bfi):
        dt = self.dt
        f = lambda v: dt.type(v)
        B = len(bits)
        # parameters (26 LSF bits, then per subframe pitch, code, gains)
        mean = np.asarray(LSF_MEAN, dt)[:, None]
        lsf = mean + f(LSF_PRED) * (self.lsf_prev - mean)
        pos = 0
        for i, nb in enumerate(LSF_BITS):
            q = _take(bits, pos, nb).astype(dt)
            lsf[i] = lsf[i] + f(LSF_SPAN) * (f(2.0) * q / f((1 << nb) - 1)
                                             - f(1.0))
            pos += nb
        for i in range(1, ORDER):
            lsf[i] = np.maximum(lsf[i], lsf[i - 1] + f(LSF_GAP))
        for i in range(ORDER - 1, -1, -1):
            lsf[i] = np.minimum(lsf[i],
                                f(3.10) - f(ORDER - 1 - i) * f(LSF_GAP))
        lag2 = np.zeros((4, B), np.int64)
        alg = np.zeros((4, B), np.int64)
        gains = np.zeros((4, B), np.int64)
        for s in range(4):
            if s == 0:
                lag2[0] = LAG2_MIN + _take(bits, pos, 8)
                pos += 8
            else:
                lag2[s] = np.clip(lag2[s - 1] + _take(bits, pos, 5) - 15,
                                  LAG2_MIN, LAG2_MAX)
                pos += 5
            alg[s] = _take(bits, pos, 16)
            gains[s] = _take(bits, pos + 16, 6)
            pos += 22
        # a bad frame repeats the previous LSFs and lag, with no code
        lsf = np.where(bfi, self.lsf_prev, lsf)
        lag2 = np.where(bfi, self.prev_lag2, lag2)
        alg[:, bfi] = 0
        gains[:, bfi] = 0

        out = np.zeros((FRAME, B), np.int16)
        taps = np.asarray(HALF_TAPS, dt)
        cols = np.arange(B)
        flat = self.exc.reshape(-1)
        for s in range(4):
            w = f((s + 1) / 4.0)
            a = lsf_to_lpc(((f(1.0) - w) * self.lsf_prev + w * lsf).T
                           ).T.astype(dt)
            # gains: 3 bits pitch gain, 3 bits code gain (log predictor)
            gp = f(1.2) * ((gains[s] >> 3) & 7).astype(dt) / f(7.0)
            self.log_gc = (f(0.6) * self.log_gc + f(0.4) * f(5.5)
                           + f(0.35) * ((gains[s] & 7).astype(dt) - f(3.5)))
            gc = _exp(np.clip(self.log_gc, f(0.0), f(9.0)))
            gp = np.where(bfi, self.prev_gp * f(0.9), gp)
            gc = np.where(bfi, f(0.0), gc)
            # adaptive codebook at half-sample lags, sample by sample (a
            # lag under the subframe reads samples just written)
            base = HIST + s * SUB
            lag = lag2[s] >> 1
            odd = (lag2[s] & 1) == 1
            at0 = (base - lag - 4) * B + cols + np.arange(8)[:, None] * B
            for i in range(SUB):
                win = flat[at0 + i * B]
                prod = taps[:, None] * win
                frac = np.zeros(B, dt)
                for k in range(8):
                    frac += prod[k]
                flat[(base + i) * B:(base + i + 1) * B] = gp * np.where(
                    odd, frac, win[4])
            e = self.exc[base:base + SUB]
            code = np.zeros((SUB, B), dt)
            for track in range(4):
                field = (alg[s] >> (4 * track)) & 0xF
                code[15 * track + 2 * (field >> 1), cols] = np.where(
                    field & 1, f(-1.0), f(1.0))
            e += gc * code
            erms = np.full(B, 1e-6, dt)
            for i in range(SUB):
                erms = erms + e[i] * e[i]
            erms = np.sqrt(erms / f(SUB))
            big = erms > f(4096.0)
            e[:, big] *= f(4096.0) / erms[big]
            self.prev_gp = gp
            self.prev_lag2 = lag2[s].copy()
            # synthesis filter 1 / A(z)
            syn = _all_pole(e, a, self.mem_syn)
            self.mem_syn = syn[::-1][:ORDER].copy()
            pcm = self._postfilter(a, syn)
            # 100 Hz high-pass, x8, s16 (truncated toward zero)
            x1, x2, y1, y2 = self.hp
            xin = np.concatenate([x2[None], x1[None], pcm])
            fir = (f(HP_B[0]) * xin[2:] + f(HP_B[1]) * xin[1:-1]
                   + f(HP_B[2]) * xin[:-2])
            for i in range(SUB):
                yv = fir[i] - f(HP_A[0]) * y1 - f(HP_A[1]) * y2
                y2, y1 = y1, yv
                v = np.clip(yv * f(8.0), f(-32768.0), f(32767.0))
                out[s * SUB + i] = np.trunc(v).astype(np.int16)
            self.hp = np.stack([pcm[-1], pcm[-2], y1, y2])
        self.exc[:HIST] = self.exc[FRAME:].copy()
        self.lsf_prev = lsf.copy()
        return out

    def _postfilter(self, a, x):
        """A(z/0.65) / A(z/0.75), adaptive tilt, AGC to the input's energy."""
        dt = self.dt
        f = lambda v: dt.type(v)
        B = x.shape[1]
        gn = np.cumprod(np.full(ORDER, 0.65, dt)).astype(dt)[:, None]
        gd = np.cumprod(np.full(ORDER, 0.75, dt)).astype(dt)[:, None]
        an, ad = a * gn, a * gd
        xh = np.concatenate([self.pf_num[::-1], x])
        tmp = x.copy()
        for j in range(ORDER):
            tmp = tmp + an[j] * xh[ORDER - 1 - j:ORDER - 1 - j + SUB]
        self.pf_num = x[::-1][:ORDER].copy()
        out = _all_pole(tmp, ad, self.pf_den)
        self.pf_den = out[::-1][:ORDER].copy()
        # tilt from the first reflection coefficient of the filter's
        # 22-sample impulse response
        h = np.zeros((22, B), dt)
        for i in range(22):
            v = np.full(B, 1.0, dt) if i == 0 else (
                an[i - 1].copy() if i - 1 < ORDER else np.zeros(B, dt))
            for j in range(min(ORDER, i)):
                v = v - ad[j] * h[i - 1 - j]
            h[i] = v
        r0 = np.full(B, 1e-6, dt)
        r1 = np.zeros(B, dt)
        for i in range(22):
            r0 = r0 + h[i] * h[i]
        for i in range(21):
            r1 = r1 + h[i] * h[i + 1]
        k1 = r1 / r0
        mu = np.where(k1 > f(0.0), f(0.5) * k1, f(0.25) * k1)
        ein = np.full(B, 1e-6, dt)
        eout = np.full(B, 1e-6, dt)
        for i in range(SUB):
            ein = ein + x[i] * x[i]
            eout = eout + out[i] * out[i]
        g = np.sqrt(ein / eout)
        self.agc = f(0.9) * self.agc + f(0.1) * g
        prev = np.concatenate([self.tilt[None], out[:-1]])
        self.tilt = out[-1].copy()
        return (out - mu * prev) * self.agc


def synthesize(items: list, dtype=np.float32) -> list:
    """PCM of calls, each a list of (frames (2, 137), bad (2,), half)
    slots in time order: 480 samples a slot (a half: 240 of silence, then
    its frame 2).  The calls run side by side (Synth).  Returns one (n, 480)
    int16 array a call."""
    B = len(items)
    syn = Synth(B, dtype)
    steps = []
    for b, slots in enumerate(items):
        seq = []
        for k, (frames, bad, half) in enumerate(slots):
            for j in ((1,) if half else (0, 1)):
                seq.append((k, j, frames[j], bool(bad[j])))
        steps.append(seq)
    outs = [np.zeros((len(s), 480), np.int16) for s in items]
    for t in range(max((len(s) for s in steps), default=0)):
        bits = np.zeros((B, FRAME_BITS), np.uint8)
        bfi = np.zeros(B, bool)
        active = np.array([t < len(s) for s in steps])
        for b in np.nonzero(active)[0]:
            _, _, fr, bad = steps[b][t]
            bits[b], bfi[b] = fr, bad
        pcm = syn.frame(bits, bfi, active)
        for b in np.nonzero(active)[0]:
            k, j, _, _ = steps[b][t]
            outs[b][k, 240 * j:240 * (j + 1)] = pcm[b]
    return outs
