"""Multi-host run: 2 local jax.distributed processes over byte-range
input shards must reproduce the single-host golden output exactly
(SAM concatenated in shard order + additively merged junction table).

Contention caveat: Gloo's collective-context init has a hardcoded
30 s key-value timeout (C++, not tunable from Python); on a 1-core
host running other heavy jobs the peer process can be starved past
it, failing a test with DEADLINE_EXCEEDED. Rerun on a quieter host —
the subprocess timeouts here are sized (900 s) so only that inner
Gloo limit is the flake point."""

import os
import socket
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
DATA = os.path.join(HERE, "data")
GOLD = os.path.join(HERE, "golden")


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("reads,golden,extra", [
    ("se_exact.fa", "c1_se_exact", []),
    ("spliced.fa", "c3_spliced", []),
    # split gz pair and interleaved pairs exercise the round-robin
    # (_StridedReader) sharding path end-to-end
    ("pe_1.fq.gz", "c6_pe_gz", ["-f2", "{DATA}/pe_2.fq.gz", "-mis", "5",
                                "--batch", "16"]),
    ("pe_inter.fq", "c7_pe_inter", ["-p", "-mis", "5", "--batch", "16"]),
])
def test_two_process_run_matches_golden(tmp_path, reads, golden, extra):
    extra = [a.format(DATA=DATA) for a in extra]
    port = _free_port()
    out = tmp_path / "out.sam"
    sj = tmp_path / "junctions.tab"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    for pid in range(2):
        cmd = [sys.executable, "-m", "dart_tpu.cli",
               "-i", os.path.join(GOLD, "index", "toy"),
               "-f", os.path.join(DATA, reads),
               "-o", str(out), "-j", str(sj), "-silent",
               "--dist-coordinator", f"127.0.0.1:{port}",
               "--dist-nprocs", "2", "--dist-pid", str(pid), *extra]
        procs.append(subprocess.Popen(cmd, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE))
    for p in procs:
        try:
            outb, errb = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, errb.decode()[-2000:]

    got = out.read_text()
    want = open(os.path.join(GOLD, f"{golden}.sam")).read()
    assert got == want
    assert sj.read_text() == open(
        os.path.join(GOLD, f"{golden}.junctions.tab")).read()


def test_two_process_bam_output(tmp_path):
    """-bo in distributed mode: host 0 encodes the shard merge to BAM;
    decoded records must match the single-host SAM golden."""
    from test_bam import decode_bam

    port = _free_port()
    out = tmp_path / "out.bam"
    sj = tmp_path / "junctions.tab"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    procs = []
    for pid in range(2):
        cmd = [sys.executable, "-m", "dart_tpu.cli",
               "-i", os.path.join(GOLD, "index", "toy"),
               "-f", os.path.join(DATA, "spliced.fa"),
               "-bo", str(out), "-j", str(sj), "-silent", "--batch", "16",
               "--dist-coordinator", f"127.0.0.1:{port}",
               "--dist-nprocs", "2", "--dist-pid", str(pid)]
        procs.append(subprocess.Popen(cmd, env=env,
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE))
    for p in procs:
        try:
            _, errb = p.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        assert p.returncode == 0, errb.decode()[-2000:]

    golden_lines = [l for l in open(os.path.join(GOLD, "c3_spliced.sam"))
                    if not l.startswith("@")]
    _, refs, records = decode_bam(str(out))
    assert len(records) == len(golden_lines)
    for rec, line in zip(records, golden_lines):
        f = line.rstrip("\n").split("\t")
        assert rec["name"] == f[0] and rec["flag"] == int(f[1])
        assert rec["pos"] == int(f[3]) and rec["cigar"] == f[5]


def test_two_process_checkpoint_resume(tmp_path):
    """Per-host checkpoint: both hosts crash mid-run (injected), then a
    restarted job resumes each shard from its last completed chunk and
    still produces the golden output."""
    out = tmp_path / "out.sam"
    sj = tmp_path / "junctions.tab"
    base_env = dict(os.environ)
    base_env["JAX_PLATFORMS"] = "cpu"
    base_env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    base_env["PYTHONPATH"] = REPO + os.pathsep + base_env.get("PYTHONPATH", "")

    def launch(env):
        port = _free_port()
        procs = []
        for pid in range(2):
            cmd = [sys.executable, "-m", "dart_tpu.cli",
                   "-i", os.path.join(GOLD, "index", "toy"),
                   "-f", os.path.join(DATA, "spliced.fa"),
                   "-o", str(out), "-j", str(sj), "-silent",
                   "--batch", "64", "--checkpoint",
                   "--dist-coordinator", f"127.0.0.1:{port}",
                   "--dist-nprocs", "2", "--dist-pid", str(pid)]
            procs.append(subprocess.Popen(cmd, env=env,
                                          stdout=subprocess.PIPE,
                                          stderr=subprocess.PIPE))
        outs = []
        for p in procs:
            try:
                outs.append(p.communicate(timeout=900))
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
        return [p.returncode for p in procs], outs

    env1 = dict(base_env)
    env1["DART_TPU_TEST_CRASH_AFTER_CHUNKS"] = "2"
    rcs, outs = launch(env1)
    assert any(rc != 0 for rc in rcs), "crash hook did not fire"
    assert os.path.exists(str(out) + ".shard0000.ckpt")

    rcs, outs = launch(base_env)
    assert rcs == [0, 0], outs[0][1].decode()[-2000:]
    assert not os.path.exists(str(out) + ".shard0000.ckpt")

    golden_lines = [l for l in open(os.path.join(GOLD, "c3_spliced.sam"))
                    if not l.startswith("@")]
    got = [l for l in open(out) if not l.startswith("@")]
    assert got == golden_lines
    assert sj.read_text() == open(
        os.path.join(GOLD, "c3_spliced.junctions.tab")).read()


@pytest.mark.parametrize("pid,nprocs,cards,want", [
    (0, 2, 0, None),   # no cards: each process has its own CPU device
    (1, 2, 2, [1]),
    (3, 4, 4, [3]),
    (2, 4, 8, [2]),
])
def test_card_ids_one_card_per_process(pid, nprocs, cards, want):
    from dart_tpu.parallel.distributed import card_ids

    assert card_ids(pid, nprocs, cards) == want


def test_card_ids_refuse_to_share_a_card(monkeypatch):
    from dart_tpu.parallel.distributed import card_ids, host_cards

    with pytest.raises(RuntimeError):
        card_ids(0, 4, 2)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    assert host_cards() == 0
