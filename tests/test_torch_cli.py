"""The port's CLI apps (python -m tetra_tpu_torch.apps.tetra_tx / tetra_rx
--device cpu) in subprocesses, against the JAX package's CLIs on the same
captures, and the host pieces they stand on (load_iq, IqStream).

tetra_tx: a clean capture equals the reference's to the reference's own
float32 phase drift (it sums its cumulative phase in float32 radians,
the port counts pi/4 steps exactly: readings <= 6.8e-4 over 120 slots,
held to 1e-3); with --cfo (and no --snr, so 200 dB of noise) the same.
tetra_rx: the summary JSON (lock, MCC/MNC/CC, CRC tallies per channel)
equals the reference CLI's for each --demod, the wideband host path,
--mac-workers, --state resume and --metrics; --mode 1 sends the same bits; --voice with
--keystore writes the same PCM.  --fleet --voice --keystore writes each
call's PCM through the fleet's voice monitor."""

import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_TX = 1e-3
KEYS = ("network mcc 262 mnc 1234 ksg_type 1 security_class 2\n"
        "key mcc 262 mnc 1234 addr 0 key_type 1 key_num 3 "
        "key 00112233445566778899\n")


def run(pkg: str, app: str, *args, check: bool = True):
    """`python -m <pkg>.apps.<app> args` (the port on the CPU), one torch
    thread; returns the CompletedProcess."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    extra = ["--device", "cpu"] if pkg == "tetra_tpu_torch" else []
    res = subprocess.run([sys.executable, "-m", f"{pkg}.apps.{app}",
                          *map(str, args), *extra], capture_output=True,
                         text=True, timeout=400, env=env, cwd=REPO)
    if check:
        assert res.returncode == 0, res.stderr[-1500:]
    return res


def last_json(res):
    return json.loads(res.stdout.strip().splitlines()[-1])


PKGS = ("tetra_tpu_torch", "tetra_tpu")


@pytest.fixture(scope="module")
def caps(tmp_path_factory):
    """Captures written by the port's tetra_tx: one channel (120 slots,
    25 dB, 200 Hz), a short one (40 slots), a 4-carrier wideband one
    (cells on carriers 1 and 3), and a voiced encrypted one."""
    d = tmp_path_factory.mktemp("cli")
    keys = d / "keys.txt"
    keys.write_text(KEYS)
    out = {"dir": d, "keys": str(keys)}
    jobs = {"one": ["--slots", 120, "--cfo", 200, "--snr", 25],
            "short": ["--slots", 40, "--cfo", 150, "--snr", 28],
            "wide": ["--slots", 150, "--wideband", 4, "--channels", "1,3",
                     "--mcc", 310, "--mnc", 77],
            "voice": ["--slots", 150, "--voice-tn", 2, "--keystore", keys,
                      "--snr", 30]}
    for name, args in jobs.items():
        out[name] = str(d / f"{name}.cf32")
        info = last_json(run("tetra_tpu_torch", "tetra_tx", out[name], *args))
        assert info["samples"] > 0
    return out


@pytest.mark.parametrize("extra", [[], ["--cfo", "-310"]])
def test_tetra_tx_matches_jax(tmp_path, extra):
    files = {}
    for pkg in PKGS:
        files[pkg] = str(tmp_path / f"{pkg}.cf32")
        info = last_json(run(pkg, "tetra_tx", files[pkg], "--slots", 120,
                             "--mcc", 901, "--mnc", 4321, "--cc", 13, *extra))
        assert info["sample_rate"] == 36000 and info["slots"] == 120
    a, b = (np.fromfile(files[p], np.complex64) for p in PKGS)
    assert a.shape == b.shape == (120 * 510,)
    assert np.abs(a - b).max() <= TOL_TX


def test_tetra_tx_wideband_matches_jax(tmp_path):
    files = {}
    for pkg in PKGS:
        files[pkg] = str(tmp_path / f"{pkg}.cf32")
        info = last_json(run(pkg, "tetra_tx", files[pkg], "--slots", 40,
                             "--wideband", 4, "--channels", "0,2"))
        assert info["sample_rate"] == 100_000
    a, b = (np.fromfile(files[p], np.complex64) for p in PKGS)
    assert a.shape == b.shape and np.abs(a - b).max() <= TOL_TX


def _both(*args):
    return [last_json(run(pkg, "tetra_rx", *args)) for pkg in PKGS]


@pytest.mark.parametrize("demod", ["fast", "ff", "exact"])
def test_tetra_rx_demod_matches_jax(caps, demod):
    got, ref = _both(caps["one"], "--demod", demod, "--status-every", 100)
    assert got == ref
    assert got[0]["locked"] and (got[0]["mcc"], got[0]["mnc"]) == (262, 1234)
    assert got[0]["crc_ok"] > 50


def test_tetra_rx_wideband_ff_matches_jax(caps):
    """--wideband 4 --demod ff: the host path (channelize, resample, the
    narrowband ff receiver)."""
    got, ref = _both(caps["wide"], "--wideband", 4, "--demod", "ff",
                     "--status-every", 100)
    assert got == ref
    for s in got:
        if s["channel"] in (1, 3):
            assert s["locked"] and (s["mcc"], s["mnc"]) == (310, 77)


def _netsyms(pkg, path):
    sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    sock.bind(("127.0.0.1", 0))
    sock.settimeout(0.2)
    with sock:
        out = last_json(run(pkg, "tetra_rx", path, "--mode", 1, "--demod",
                            "ff", "--udp",
                            f"127.0.0.1:{sock.getsockname()[1]}"))
        got = b""
        try:
            while True:
                got += sock.recvfrom(65536)[0]
        except socket.timeout:
            pass
    return out, got


def test_tetra_rx_mode1_matches_jax(caps):
    """--mode 1 streams the same bits in both packages; with --demod ff it
    runs the exact chain, the reference's quirk."""
    (a, bits_a), (b, bits_b) = (_netsyms(p, caps["short"]) for p in PKGS)
    assert a == b == {"mode": 1, "sent_bits": True, "ts_found": True}
    assert len(bits_a) > 10_000 and bits_a == bits_b


def test_tetra_rx_voice_keystore_matches_jax(caps):
    """--voice with --keystore: the same summary, the same decrypted LLC
    lines and the same PCM."""
    outs = {}
    for pkg in PKGS:
        pcm = str(caps["dir"] / f"{pkg}.s16")
        res = run(pkg, "tetra_rx", caps["voice"], "-v", "--voice", pcm,
                  "--keystore", caps["keys"], "--status-every", 100)
        outs[pkg] = (last_json(res),
                     [ln for ln in res.stdout.splitlines() if "LLC" in ln],
                     np.fromfile(pcm, np.int16))
    (s_a, llc_a, pcm_a), (s_b, llc_b, pcm_b) = outs.values()
    assert s_a == s_b and s_a[0]["locked"]
    assert llc_a == llc_b and len(llc_a) > 20
    assert len(pcm_a) >= 480 * 10 and np.array_equal(pcm_a, pcm_b)


def test_tetra_rx_fleet_voice_keystore_writes_each_call(caps, tmp_path,
                                                       monkeypatch):
    """--fleet --voice --keystore: the fleet's voice monitor decrypts the
    TEA1 cell's call on timeslot 2 and writes it to <name>.c0.t2<ext>, the
    PCM of an in-process fleet receiver's take_voice() fed the same
    blocks, every slot decrypted once the cipher state is known and none
    flagged bad; --keystore without --voice is refused."""
    import torch
    from tetra_tpu_torch.apps.tetra_rx import load_iq
    from tetra_tpu_torch.rx.receiver import TetraReceiver
    from tetra_tpu_torch.voice import monitor as M
    monkeypatch.setenv("TETRA_FLEET_THREADS", "1")
    # five multiframes: the SYSINFO PDUs bring the CCK id and the
    # hyperframe in turn, after which every slot decrypts
    cap = str(tmp_path / "voice.cf32")
    run("tetra_tpu_torch", "tetra_tx", cap, "--slots", 360, "--voice-tn", 2,
        "--keystore", caps["keys"], "--snr", 30)
    out = str(tmp_path / "calls" / "calls.s16")
    os.makedirs(tmp_path / "calls")
    summary = last_json(run("tetra_tpu_torch", "tetra_rx", cap, "--fleet",
                            "--voice", out, "--keystore", caps["keys"],
                            "--status-every", 100))
    assert summary[0]["locked"] and summary[0]["mnc"] == 1234
    assert os.listdir(tmp_path / "calls") == ["calls.c0.t2.s16"]
    got = np.fromfile(tmp_path / "calls" / "calls.c0.t2.s16", np.int16)
    rx = TetraReceiver(1, events=False, fleet=True, voice=True,
                       keystore=caps["keys"], device="cpu")
    iq = load_iq(cap)
    blocks = []
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for i in range(len(iq) // 4096):
            rx.process(iq[None, i * 4096:(i + 1) * 4096])
            blocks += rx.take_voice()
    finally:
        torch.set_num_threads(threads)
    rows = [(b.crypt[i], b.bfi[i].any(), b.pcm[i]) for b in blocks
            for i in range(len(b))]
    assert len(rows) >= 50
    assert np.array_equal(got, np.concatenate([p for _, _, p in rows]))
    crypt = [c for c, _, _ in rows]
    assert crypt[-40:] == [M.DECRYPTED] * 40
    assert not any(bad for c, bad, _ in rows if c == M.DECRYPTED)
    assert np.abs(got[-4800:]).max() > 100
    res = run("tetra_tpu_torch", "tetra_rx", cap, "--fleet",
              "--keystore", caps["keys"], check=False)
    assert res.returncode != 0 and "--voice" in res.stderr


def test_tetra_rx_state_resume_matches_jax(caps):
    """--state: a checkpoint saved at the end of one run resumes the next
    run on the same capture, in each package."""
    finals = []
    for pkg in PKGS:
        state = str(caps["dir"] / f"{pkg}.npz")
        first = last_json(run(pkg, "tetra_rx", caps["one"], "--state", state,
                              "--status-every", 100))
        second = last_json(run(pkg, "tetra_rx", caps["one"], "--state",
                               state, "--status-every", 100))
        assert second[0]["crc_ok"] > first[0]["crc_ok"] * 1.5
        finals.append((first, second))
    assert finals[0] == finals[1]


def test_tetra_rx_metrics_dashboard_matches_jax(caps):
    recs = {}
    for pkg in PKGS:
        mfile = caps["dir"] / f"{pkg}.jsonl"
        res = run(pkg, "tetra_rx", caps["one"], "--dashboard", "--metrics",
                  mfile, "--status-every", 0.7)
        assert "constellation ch0" in res.stdout
        assert "receiver status" in res.stdout
        recs[pkg] = [json.loads(ln) for ln in open(mfile)]
    a, b = recs.values()
    # the fast chain's plain versions round unlike the reference's XLA
    # twins: quality (a mean |phase error|) within 2e-3, as the receiver
    # tests hold it; every other field but the time stamp equal
    strip = lambda r: {k: v for k, v in r.items() if k not in ("ts",
                                                               "quality")}
    assert len(a) >= 2 and [strip(r) for r in a] == [strip(r) for r in b]
    np.testing.assert_allclose([r["quality"] for r in a],
                               [r["quality"] for r in b], atol=2e-3)
    assert a[-1]["locked"] and a[-1]["mcc"] == 262


def test_tetra_rx_profile_writes_a_trace(caps, tmp_path):
    tdir = tmp_path / "trace"
    res = run("tetra_tpu_torch", "tetra_rx", caps["short"], "--status-every",
              100, "--profile", tdir)
    assert last_json(res)[0]["channel"] == 0
    trace = tdir / "tetra_rx.pt.trace.json"
    assert trace.exists() and "traceEvents" in json.loads(trace.read_text())


def test_tetra_rx_fleet_profile_holds_the_program_ranges(caps, tmp_path):
    """--fleet --profile: the trace holds the receiver's own ranges, each
    engine call inside a superblock."""
    tdir = tmp_path / "trace"
    res = run("tetra_tpu_torch", "tetra_rx", caps["wide"], "--wideband", 4,
              "--fleet", "--wb-k", 2, "--status-every", 100, "--profile",
              tdir)
    assert last_json(res)[1]["locked"]
    events = json.loads((tdir / "tetra_rx.pt.trace.json").read_text())
    ranges: dict = {}
    for e in events["traceEvents"]:
        if e.get("ph") == "X" and e["name"].startswith("tetra."):
            ranges.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e["dur"]))
    assert {"tetra.ingest", "tetra.superblock", "tetra.engine",
            "tetra.fec"} <= set(ranges), sorted(ranges)
    for a, b in ranges["tetra.engine"]:
        assert any(s0 <= a and b <= s1
                   for s0, s1 in ranges["tetra.superblock"])


def test_tetra_rx_mac_workers_raises(caps):
    """--mac-workers 2 (the host MAC pool: two CPU worker processes) no
    longer raises: it prints the summary JSON and the -v event lines of the
    in-process run, and those of the JAX CLI on the same capture."""
    def lines(res):
        return [ln for ln in res.stdout.splitlines() if ln.startswith("[ch")]
    args = (caps["one"], "-v", "--status-every", 100)
    pooled = run("tetra_tpu_torch", "tetra_rx", *args, "--mac-workers", 2)
    inproc = run("tetra_tpu_torch", "tetra_rx", *args)
    ref = run("tetra_tpu", "tetra_rx", *args)
    assert last_json(pooled) == last_json(inproc) == last_json(ref)
    assert last_json(pooled)[0]["locked"]
    assert lines(pooled) == lines(inproc) == lines(ref)
    assert len(lines(pooled)) > 10


def test_entry_points_need_cuda_or_cpu(caps):
    """With no --device the apps run on the current CUDA device; without
    CUDA they fail rather than fall back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    for app, path in (("tetra_rx", caps["short"]),
                      ("tetra_tx", str(caps["dir"] / "x.cf32"))):
        res = subprocess.run([sys.executable, "-m",
                              f"tetra_tpu_torch.apps.{app}", path],
                             capture_output=True, text=True, timeout=200,
                             env=env, cwd=REPO)
        assert res.returncode != 0 and "CUDA is unavailable" in res.stderr


def test_load_iq_formats_match_jax(caps, tmp_path):
    """load_iq reads cf32, cs16, cu8 and 2-channel WAV like the
    reference's, and raises on a WAV at the wrong rate."""
    import wave

    from tetra_tpu.apps.tetra_rx import load_iq as jax_load
    from tetra_tpu_torch.apps.tetra_rx import load_iq
    ref = np.fromfile(caps["short"], np.complex64)[:4096]
    flat = np.stack([ref.real, ref.imag], axis=1).reshape(-1)
    s16 = np.round(flat * 32000.0 / np.abs(flat).max()).astype(np.int16)
    (tmp_path / "a.cs16").write_bytes(s16.tobytes())
    u8 = np.round(flat * (120.0 / np.abs(flat).max()) + 127.5).astype(
        np.uint8)
    (tmp_path / "a.cu8").write_bytes(u8.tobytes())
    (tmp_path / "a.cs8").write_bytes(np.round(
        flat * 100.0 / np.abs(flat).max()).astype(np.int8).tobytes())
    for rate, name in ((36000, "a.wav"), (2_400_000, "b.wav")):
        with wave.open(str(tmp_path / name), "wb") as w:
            w.setnchannels(2)
            w.setsampwidth(2)
            w.setframerate(rate)
            w.writeframes(s16.tobytes())
    for name in ("a.cs16", "a.cu8", "a.cs8", "a.wav"):
        got = load_iq(str(tmp_path / name))
        np.testing.assert_array_equal(got, jax_load(str(tmp_path / name)))
        assert got.dtype == np.complex64 and len(got) == 4096, name
    np.testing.assert_array_equal(load_iq(caps["short"]),
                                  np.fromfile(caps["short"], np.complex64))
    with pytest.raises(ValueError, match="2400000 Hz.*36000"):
        load_iq(str(tmp_path / "b.wav"), expect_rate=36000)


def test_iq_stream_feed_file_reads_the_file(tmp_path):
    """IqStream over the port's build of iq_stream.cpp: feed_file, then
    read until EOF, returns the file's samples in order."""
    from tetra_tpu_torch.runtime.iq_stream import IqStream
    data = (np.arange(30000) - 1j * np.arange(30000)).astype(np.complex64)
    f = tmp_path / "x.cf32"
    data.tofile(f)
    s = IqStream()
    s.feed_file(str(f))
    got = []
    while True:
        blk = s.read(4096, timeout_ms=500)
        if len(blk) == 0:
            break
        got.append(blk)
    assert np.array_equal(np.concatenate(got), data)
    assert s.overruns == 0 and s.eof and s.total == 30000
    s.stop()
