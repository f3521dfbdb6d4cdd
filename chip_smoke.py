#!/usr/bin/env python3
"""End-to-end smoke run of the aligner on an NVIDIA GPU.

    python3 chip_smoke.py            # one card: every phase below
    python3 chip_smoke.py --multi    # four cards: the multi-card paths only

One card, phases in order (any failure exits non-zero with no ok line):
1. device: JAX must compute on a GPU; nvidia-smi names the card.
2. native: build libdart_native from the sources on this host.
3. goldens: `pytest -m gpu` (the nine golden configs through the jax
   engine, and the wide engine against the NumPy oracle, on the card).
4. main path: 100k-read 50 Mbp single-end and 50k-pair 8 Mbp paired-end
   + BAM datasets through the CLI path with --engine jax, record for
   record against --engine numpy (ops/fm_numpy.py, no shared device code)
   run on the CPU; junction tables likewise. Set-up, compile, memory and
   stage-split lines are printed as information.
5. wide engine: FMIndexJaxWide on the 50 Mbp index (no >=2^31 text fits
   a run's time limit), seed tables and locates bit-equal to FMIndexNumpy.
6. last line: {"ok": true, "device": {...}}.

--multi (four cards) runs the 50 Mbp single-end dataset through one card,
--mesh data=4, --mesh data=2,index=2 and --dist-nprocs 4 (one process per
card), and requires every output to be byte-identical to the one-card run.

The parent process never imports JAX: each phase is a child process, and
only one child at a time holds a card (a JAX process reserves most of a
card's memory). Children that compute on the card run with
JAX_PLATFORMS=cuda, so a missing GPU is an error, never a CPU fallback.
--rehearse runs every phase on the CPU backend at a small size, to check
the script where there is no GPU; it never prints the ok line.
Datasets, outputs and per-phase logs go under .smoke_data/ in the checkout.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
N_READS = 100_000
WIDE_READS = 20_000
MAX_DUP = 100
DATASETS = {
    # bench.py configs; "rehearse" shrinks scale only
    "50mbp_se": dict(genome={"chr1": 30_000_000, "chr2": 20_000_000},
                     paired=False, bam=False,
                     rehearse={"chr1": 3_000_000, "chr2": 2_000_000}),
    "8mbp_pe_bam": dict(genome={"chr1": 5_000_000, "chr2": 3_000_000},
                        paired=True, bam=True,
                        rehearse={"chr1": 1_000_000, "chr2": 600_000}),
}
REHEARSE_READS = 6_000


class SmokeFailure(Exception):
    pass


# ------------------------------------------------------------------ parent


class Smoke:
    def __init__(self, args):
        self.args = args
        self.work = os.path.join(
            HERE, ".smoke_data",
            f"{'rehearse' if args.rehearse else 'full'}-{args.seed}")
        self.logs = os.path.join(self.work, "logs")
        os.makedirs(self.logs, exist_ok=True)
        self.label = "[card not read]"
        self.background: dict[str, tuple[subprocess.Popen, object]] = {}
        self.t0 = time.time()

    def say(self, msg: str) -> None:
        print(f"{self.label} {msg}", flush=True)

    def _env(self, platform: str, devices: int = 1) -> dict:
        env = dict(os.environ)
        env["PYTHONPATH"] = HERE + os.pathsep + env.get("PYTHONPATH", "")
        if self.args.rehearse:
            platform = "cpu"
        env["JAX_PLATFORMS"] = platform
        if platform == "cpu":
            env["XLA_FLAGS"] = (
                f"--xla_force_host_platform_device_count={devices}")
        return env

    def _cmd(self, child: str, *extra: str) -> list[str]:
        cmd = [sys.executable, os.path.abspath(__file__), "--child", child,
               "--seed", str(self.args.seed)]
        if self.args.rehearse:
            cmd.append("--rehearse")
        return cmd + list(extra)

    def _echo(self, name: str, path: str, rc: int) -> list[str]:
        with open(path, errors="replace") as f:
            lines = f.read().splitlines()
        for line in lines:
            if line.startswith("INFO "):
                self.say(line[5:])
        if rc != 0:
            print(f"--- last lines of {name} ({path}) ---", file=sys.stderr)
            print("\n".join(lines[-60:]), file=sys.stderr)
            raise SmokeFailure(f"phase {name} exited with {rc}")
        return lines

    def run(self, name: str, child: str, *extra: str, platform: str = "cuda",
            devices: int = 1, timeout: float = 900) -> list[str]:
        """Run one child to its end; echo its INFO lines."""
        log = os.path.join(self.logs, f"{name}.log")
        t0 = time.time()
        with open(log, "w") as f:
            try:
                rc = subprocess.run(
                    self._cmd(child, *extra), stdout=f,
                    stderr=subprocess.STDOUT, cwd=HERE, timeout=timeout,
                    env=self._env(platform, devices)).returncode
            except subprocess.TimeoutExpired:
                rc = 124
        lines = self._echo(name, log, rc)
        self.say(f"phase {name}: ok in {time.time() - t0:.1f} s")
        return lines

    def start(self, name: str, child: str, *extra: str,
              platform: str = "cpu", devices: int = 1) -> None:
        """Start a child in the background (CPU children only, or
        children that each own a card)."""
        log = os.path.join(self.logs, f"{name}.log")
        f = open(log, "w")
        p = subprocess.Popen(self._cmd(child, *extra), stdout=f,
                             stderr=subprocess.STDOUT, cwd=HERE,
                             env=self._env(platform, devices))
        self.background[name] = (p, f, time.time())

    def wait(self, name: str, timeout: float = 900) -> list[str]:
        p, f, t0 = self.background.pop(name)
        try:
            rc = p.wait(timeout=max(1.0, timeout - (time.time() - t0)))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            rc = 124
        f.close()
        lines = self._echo(name, os.path.join(self.logs, f"{name}.log"), rc)
        self.say(f"phase {name}: ok in {time.time() - t0:.1f} s")
        return lines

    def stop_all(self) -> None:
        for p, f, _ in self.background.values():
            if p.poll() is None:
                p.kill()
                p.wait()
            f.close()
        self.background.clear()

    # ---- phases shared by both modes ----

    def device(self, want: int) -> dict:
        lines = self.run("device", "device")
        dev = json.loads(next(line[7:] for line in lines
                              if line.startswith("DEVICE ")))
        if not self.args.rehearse:
            if dev["platform"] != "gpu":
                raise SmokeFailure(f"JAX computes on {dev['platform']}")
            if dev["count"] < want:
                raise SmokeFailure(f"{want} cards needed, "
                                   f"{dev['count']} found")
        return dev

    def card(self) -> None:
        """Read the card's name and power limit; they label every line."""
        if self.args.rehearse:
            self.label = "[CPU rehearsal]"
            return
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        if out.returncode != 0 or not out.stdout.strip():
            raise SmokeFailure(f"nvidia-smi failed: {out.stderr.strip()}")
        self.card_lines = out.stdout.strip().splitlines()
        self.label = f"[{self.card_lines[0]}]"

    def finish(self, dev: dict, count: int) -> None:
        self.say(f"all phases passed in {time.time() - self.t0:.1f} s")
        if self.args.rehearse:
            print("rehearsal passed (CPU backend; no ok line)")
            return
        print("\n".join(self.card_lines))  # as nvidia-smi gives them
        print(json.dumps({"ok": True, "device": {
            "platform": dev["platform"], "kind": dev["kind"],
            "count": count}}))

    # ---- modes ----

    def single(self) -> None:
        dev = self.device(want=1)
        self.card()
        self.say(f"device: {dev}")
        self.run("native", "native", platform="cpu")
        self.start("data", "data", *DATASETS)
        self.gpu_tests()
        self.wait("data")
        for cname in DATASETS:
            self.start(f"oracle-{cname}", "oracle", cname)
        self.start("wide-oracle", "wide-oracle")
        self.run("align", "align", *DATASETS)
        self.wait("wide-oracle")
        self.run("wide", "wide")
        for cname in DATASETS:
            self.wait(f"oracle-{cname}")
        self.run("compare", "compare", *DATASETS, platform="cpu")
        self.finish(dev, dev["count"])

    def gpu_tests(self) -> None:
        xml = os.path.join(self.logs, "gpu_tests.xml")
        self.run("gpu-tests", "gpu-tests", xml)
        if self.args.rehearse:
            return
        import xml.etree.ElementTree as ET

        suite = ET.parse(xml).getroot()
        suite = suite if suite.tag == "testsuite" else suite[0]
        n = {k: int(suite.get(k, 0))
             for k in ("tests", "failures", "errors", "skipped")}
        self.say(f"gpu tests: {n}")
        if n["tests"] < 10 or n["failures"] or n["errors"] or n["skipped"]:
            raise SmokeFailure(f"gpu tests did not all pass on the card: {n}")

    def multi(self) -> None:
        dev = self.device(want=4)
        self.card()
        self.say(f"devices: {dev}")
        self.run("native", "native", platform="cpu")
        self.run("data", "data", "50mbp_se", platform="cpu")
        runs = [("one", []), ("mesh-data4", ["--mesh", "data=4"]),
                ("mesh-data2-index2", ["--mesh", "data=2,index=2"])]
        for tag, extra in runs:
            self.run(f"multi-{tag}", "multi-cli", tag, *extra, devices=4)
        port = _free_port()
        for pid in range(4):
            self.start(f"multi-dist-{pid}", "multi-cli", "dist",
                       "--dist-coordinator", f"localhost:{port}",
                       "--dist-nprocs", "4", "--dist-pid", str(pid),
                       platform="cuda")
        for pid in range(4):
            self.wait(f"multi-dist-{pid}")
        self.run("multi-compare", "multi-compare", platform="cpu")
        self.finish(dev, 4)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# ------------------------------------------------------------------ children
# Each runs in its own process; INFO lines are echoed by the parent.


def info(msg: str) -> None:
    print(f"INFO {msg}", flush=True)


def _manifest_path(work: str) -> str:
    return os.path.join(work, "datasets.json")


def _manifest(work: str) -> dict:
    with open(_manifest_path(work)) as f:
        return json.load(f)


def _outputs(ds: dict, tag: str) -> tuple[str, str]:
    ext = "bam" if ds["bam"] else "sam"
    return (os.path.join(ds["dir"], f"{tag}.{ext}"),
            os.path.join(ds["dir"], f"{tag}.junctions.tab"))


def _cli_argv(ds: dict, tag: str, *extra: str) -> list[str]:
    out, sj = _outputs(ds, tag)
    argv = ["-i", ds["prefix"], "-f", ds["fq"][0]]
    if ds["fq"][1]:
        argv += ["-f2", ds["fq"][1]]
    argv += ["-bo" if ds["bam"] else "-o", out, "-j", sj, "-mis", "5"]
    return argv + list(extra)


def child_device(args) -> None:
    import jax

    devs = jax.devices()
    d = devs[0]
    info(f"jax.devices(): {devs}")
    print("DEVICE " + json.dumps({"platform": d.platform,
                                  "kind": d.device_kind,
                                  "count": len(devs)}), flush=True)


def child_native(args) -> None:
    from dart_tpu.native import build
    from dart_tpu.pipeline import native_chunk

    t0 = time.time()
    fresh = build._needs_build(build._lib_path(), build.build_key())
    path = build.build()
    if build.load() is None or not native_chunk.available():
        raise SmokeFailure("native library did not load")
    info(f"native library {os.path.basename(path)} "
         f"{'built' if fresh else 'already built'} for this host in "
         f"{time.time() - t0:.1f} s (key {build.build_key()[:12]})")


def child_gpu_tests(args) -> None:
    xml = args.rest[0]
    rc = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "-q", "-rs",
         "-p", "no:cacheprovider", f"--junitxml={xml}",
         os.path.join(HERE, "tests")], cwd=HERE).returncode
    if rc != 0:
        raise SmokeFailure(f"pytest -m gpu exited with {rc}")


def child_data(args) -> None:
    sys.path.insert(0, HERE)
    import bench

    man = {}
    if os.path.exists(_manifest_path(args.work)):
        man = _manifest(args.work)
    n = REHEARSE_READS if args.rehearse else N_READS
    for cname in args.rest:
        d = DATASETS[cname]
        genome = d["rehearse"] if args.rehearse else d["genome"]
        spec = {"genome": genome, "n_reads": n, "paired": d["paired"],
                "bam": d["bam"]}
        t0 = time.time()
        ds = bench.ensure_dataset(cname, spec, work=args.work,
                                  seed=args.seed)
        info(f"dataset {cname}: {sum(genome.values()) / 1e6:.0f} Mbp "
             f"genome, {n} reads ({'pairs, BAM' if d['paired'] else 'SE'})"
             f", seed {args.seed}, ready in {time.time() - t0:.1f} s; "
             f"index build {ds['index_build_s']} s")
        man[cname] = {"fq": list(ds["fq"]), "prefix": ds["prefix"],
                      "dir": ds["dir"], "bam": d["bam"], "n_reads": n}
    with open(_manifest_path(args.work), "w") as f:
        json.dump(man, f)


def child_oracle(args) -> None:
    from dart_tpu import cli

    ds = _manifest(args.work)[args.rest[0]]
    t0 = time.time()
    rc = cli.main(_cli_argv(ds, "numpy", "--engine", "numpy", "-silent"))
    if rc != 0:
        raise SmokeFailure(f"numpy oracle exited with {rc}")
    info(f"{args.rest[0]}: --engine numpy oracle (CPU) aligned "
         f"{ds['n_reads']} reads in {time.time() - t0:.1f} s")


class _CompileCounter:
    """Counts backend compilations (or persistent-cache loads) and
    their seconds, through jax.monitoring."""

    def __init__(self):
        import jax

        self.n = 0
        self.s = 0.0
        self.hits = 0
        jax.monitoring.register_event_duration_secs_listener(self._dur)
        jax.monitoring.register_event_listener(self._ev)

    def _dur(self, event, duration, **kw):
        if event == "/jax/core/compile/backend_compile_duration":
            self.n += 1
            self.s += duration

    def _ev(self, event, **kw):
        if event == "/jax/compilation_cache/cache_hits":
            self.hits += 1

    def take(self) -> str:
        out = (f"{self.n} programs compiled in {self.s:.1f} s "
               f"({self.hits} of them loaded from the persistent cache)")
        self.n, self.s, self.hits = 0, 0.0, 0
        return out


def _mem(compiled) -> str:
    m = compiled.memory_analysis()
    return (f"args {m.argument_size_in_bytes / 2**20:.1f} MiB, "
            f"out {m.output_size_in_bytes / 2**20:.1f} MiB, "
            f"temp {m.temp_size_in_bytes / 2**20:.1f} MiB, "
            f"code {m.generated_code_size_in_bytes / 2**20:.2f} MiB")


def child_align(args) -> None:
    import jax

    from dart_tpu import cli
    from dart_tpu.aligner import DartAligner
    from dart_tpu.index import load_index

    counter = _CompileCounter()
    dev = jax.devices()[0]
    man = _manifest(args.work)
    for cname in args.rest:
        ds = man[cname]
        cfg = cli.parse_args(_cli_argv(ds, "jax", "--engine", "jax",
                                       "--stats"))
        t0 = time.time()
        idx = load_index(cfg.index_prefix)
        t_load = time.time() - t0
        t0 = time.time()
        aligner = DartAligner(idx, cfg)
        t_setup = time.time() - t0
        eng = aligner.engine
        if aligner.native is None:
            raise SmokeFailure("the aligner did not load the native library")
        plat = {d.platform for d in eng.table.devices()}
        if plat != {dev.platform}:
            raise SmokeFailure(f"engine tables on {plat}")
        info(f"{cname}: index load {t_load:.2f} s, engine set-up "
             f"{t_setup:.2f} s ({counter.take()}), tables on {plat}")
        rounds = _record_rounds(eng)
        t0 = time.time()
        aligner.run()
        wall = time.time() - t0
        cold_rounds = list(rounds)
        info(f"{cname}: cold run {wall:.2f} s for {ds['n_reads']} reads "
             f"incl. LUT build and compiles ({counter.take()})")
        info(f"{cname}: stage split {json.dumps(aligner.stats)}")
        # a warm run of the same engine: steady-state numbers, same output
        out, sj = _outputs(ds, "jax")
        cfg.output_file, cfg.sj_file = out + ".warm", sj + ".warm"
        cfg.silent = True
        warm = DartAligner(idx, cfg, eng)
        t0 = time.time()
        warm.run()
        wall2 = time.time() - t0
        for a, b in ((out, cfg.output_file), (sj, cfg.sj_file)):
            if open(a, "rb").read() != open(b, "rb").read():
                raise SmokeFailure(f"{cname}: warm run output differs")
        info(f"{cname}: warm run {wall2:.2f} s "
             f"({ds['n_reads'] / wall2:.0f} reads/s; {counter.take()}); "
             f"stage split {json.dumps(warm.stats)}")
        _report_programs(cname, eng, cold_rounds)
        info(f"{cname}: memory analysis and round replay: "
             f"{counter.take()}")
        stats = dev.memory_stats() or {}
        info(f"{cname}: peak_bytes_in_use "
             f"{stats.get('peak_bytes_in_use', 0) / 2**30:.2f} GiB")
        del aligner, warm, eng


def _record_rounds(eng) -> list:
    """Wrap the engine's seed-round dispatch to keep each round's
    input, so the rounds can be replayed one by one afterwards."""
    rounds = []
    orig = eng.submit_seed_round

    def rec(buf, Rp, Lp, T, S=None, use_nmask=False):
        rounds.append((buf, Rp, Lp, T, S, use_nmask))
        return orig(buf, Rp, Lp, T, S, use_nmask)

    eng.submit_seed_round = rec
    eng._orig_submit = orig
    return rounds


def _report_programs(cname, eng, rounds) -> None:
    """memory_analysis of the seed-scan and locate programs at the
    shapes the run used, and a replay of the first chunk's rounds:
    lanes, iteration cap, iterations run, wall time per round."""
    import functools

    import jax
    import jax.numpy as jnp
    import numpy as np

    from dart_tpu.ops import fm_jax

    shapes = {}
    for buf, Rp, Lp, T, S, nm in rounds:
        shapes.setdefault((Rp, Lp, T, nm, S), buf.shape)
    for key, shape in sorted(shapes.items()):
        c = eng._seed_jit[key].lower(
            eng.table, eng.L2, eng._lut,
            jax.ShapeDtypeStruct(shape, np.uint32)).compile()
        info(f"{cname}: seed-scan program rows={key[0]} Lp={key[1]} "
             f"T={key[2]} nmask={key[3]} S={key[4]}: {_mem(c)}")
    locs = sorted(eng._locate_jit)
    if not locs:
        # every locate batch of this run was small enough for the host
        # path; show the program a full chunk of rows would compile
        n = 65536
        T = int(eng.sa_intv * (np.log(n) + 4.0) / 32 + 1) * 32
        fn = jax.jit(functools.partial(
            fm_jax._locate_packed, primary=eng.primary,
            sa_intv=eng.sa_intv, sad_off=eng.sad_off, max_iters=T))
        c = fn.lower(eng.blocks, eng.L2,
                     jax.ShapeDtypeStruct((n,), np.int32)).compile()
        info(f"{cname}: locate program rows={n} T={T} (not run: every "
             f"locate batch of this run took the host path): {_mem(c)}")
    for npad, T in locs:
        c = eng._locate_jit[(npad, T)].lower(
            eng.blocks, eng.L2,
            jax.ShapeDtypeStruct((npad,), np.int32)).compile()
        info(f"{cname}: locate program rows={npad} T={T}: {_mem(c)}")

    # replay every seed round of the cold run on its own: lanes,
    # iteration cap, iterations run, wall time
    probes = {}
    for i, (buf, Rp, Lp, T, S, nm) in enumerate(rounds):
        key = (Rp, Lp, T, S, nm)
        if key not in probes:
            probes[key] = jax.jit(functools.partial(
                _probe_iterations, eng=eng, Lp=Lp, T=T, S=S, nm=nm))
        iters = int(probes[key](eng.table, eng.L2, eng._lut,
                                jnp.asarray(buf)))
        np.asarray(eng._orig_submit(buf, Rp, Lp, T, S, nm))  # warm
        t0 = time.time()
        np.asarray(eng._orig_submit(buf, Rp, Lp, T, S, nm))
        dt = time.time() - t0
        lanes = int((buf[:, -1] > 0).sum())
        info(f"{cname}: seed round {i + 1}: {lanes} live lanes in "
             f"{Rp} rows, cap {T}, {iters} iterations, "
             f"{dt * 1e3:.1f} ms wall ({dt / max(iters, 1) * 1e6:.1f} "
             f"us per iteration)")
    info(f"{cname}: {len(rounds)} seed rounds in the cold run")


def _probe_iterations(table, L2, lut, buf, *, eng, Lp, T, S, nm):
    """The seed-scan kernel on one round's transfer buffer; returns the
    number of iterations it ran."""
    from dart_tpu.ops import fm_jax

    wcols, nmask1, rlens = fm_jax.round_inputs(buf, Lp, nm)
    return fm_jax._seed_scan_kernel(
        table, L2, wcols, nmask1, rlens, primary=eng.primary,
        max_dup=eng.max_dup_num, max_seeds=S, max_iters=T, lut=lut,
        lut_k=eng.lut_k, ref_off=eng.ref_off, sad_off=eng.sad_off,
        sa_intv=eng.sa_intv, seq_len=eng.seq_len)[-1]


def _wide_inputs(args):
    """The first WIDE_READS reads of the 50 Mbp dataset, parsed by the
    aligner's own reader, as (codes, rlens)."""
    from dart_tpu.io.fastx import ChunkReader
    from dart_tpu.pipeline.seeding import build_codes_matrix

    ds = _manifest(args.work)["50mbp_se"]
    reader = ChunkReader(ds["fq"][0], None, False, chunk_reads=WIDE_READS)
    reads = []
    try:
        while len(reads) < WIDE_READS and (chunk := reader.next_chunk()):
            reads += chunk
    finally:
        reader.close()
    return ds, build_codes_matrix(reads[:WIDE_READS])


def _interval_rows(n, k0, fr):
    """Every SA row inside the (k0, freq) intervals of the seed tables."""
    import numpy as np

    valid = np.arange(k0.shape[1])[None, :] < n[:, None]
    sel = valid & (fr >= 1)
    starts, counts = k0[sel].astype(np.int64), fr[sel].astype(np.int64)
    if not starts.size:
        return np.zeros(0, np.int64)
    rows = np.repeat(starts - np.cumsum(counts) + counts, counts) \
        + np.arange(counts.sum())
    return np.unique(rows)


def child_wide_oracle(args) -> None:
    import numpy as np

    from dart_tpu.aligner import _NumpyEngine
    from dart_tpu.index import load_index
    from dart_tpu.ops.fm_numpy import FMIndexNumpy
    from dart_tpu.pipeline.seeding import seed_reads_from_all_walks

    ds, (codes, rlens) = _wide_inputs(args)
    t0 = time.time()
    fm = FMIndexNumpy(load_index(ds["prefix"]))
    n, rp, ln, k0, fr = seed_reads_from_all_walks(
        _NumpyEngine(fm, MAX_DUP), codes, rlens, MAX_DUP)
    rows = _interval_rows(n, k0, fr)
    np.savez(os.path.join(args.work, "wide_oracle.npz"), n=n, rp=rp, ln=ln,
             k0=k0, fr=fr, rows=rows, locs=fm.locate(rows))
    info(f"wide oracle (FMIndexNumpy, CPU): {len(rlens)} reads, "
         f"{rows.size} SA rows located in {time.time() - t0:.1f} s")


def child_wide(args) -> None:
    import jax
    import numpy as np

    from dart_tpu.index import load_index
    from dart_tpu.ops.fm_jax_wide import FMIndexJaxWide

    ds, (codes, rlens) = _wide_inputs(args)
    idx = load_index(ds["prefix"])
    lut_k = 0 if jax.default_backend() == "cpu" else 11
    t0 = time.time()
    wide = FMIndexJaxWide(idx, max_dup_num=MAX_DUP, lut_k=lut_k)
    t_setup = time.time() - t0
    o = dict(np.load(os.path.join(args.work, "wide_oracle.npz")))
    t0 = time.time()
    n, rp, ln, k0, fr = wide.seed_reads(codes, rlens)
    # the rows of both engines' intervals: the oracle's also hold the
    # single-occurrence rows that the wide engine located in-kernel
    rows = np.union1d(_interval_rows(n, k0, fr), o["rows"])
    locs = wide.locate(rows)
    t_run = time.time() - t0
    where = {int(r): int(v) for r, v in zip(o["rows"], o["locs"])}
    np.testing.assert_array_equal(n, o["n"])
    S = k0.shape[1]  # the engines size their seed slots differently
    if (n > S).any() or (o["n"] > o["k0"].shape[1]).any():
        raise SmokeFailure("more seeds than seed slots")
    for f in ("rp", "ln", "k0", "fr"):
        o[f] = o[f][:, :S]
    valid = np.arange(k0.shape[1])[None, :] < n[:, None]
    np.testing.assert_array_equal(np.where(valid, rp, 0),
                                  np.where(valid, o["rp"], 0))
    np.testing.assert_array_equal(np.where(valid, ln, 0),
                                  np.where(valid, o["ln"], 0))
    direct = valid & (fr < 0)
    # a direct seed (freq -1, genome position in k0) stands for a
    # single-occurrence interval of the oracle
    if not (o["fr"][direct] == 1).all():
        raise SmokeFailure("direct seed without a unique oracle interval")
    want_pos = [where[int(r)] for r in o["k0"][direct]]
    np.testing.assert_array_equal(k0[direct], want_pos)
    rest = valid & ~direct
    np.testing.assert_array_equal(k0[rest], o["k0"][rest])
    np.testing.assert_array_equal(fr[rest], o["fr"][rest])
    np.testing.assert_array_equal(locs, [where[int(r)] for r in rows])
    info(f"wide engine (FMIndexJaxWide, lut_k={lut_k}) on the "
         f"{idx.seq_len:,}-position text: {len(rlens)} reads, "
         f"{int(n.sum())} seeds ({int(direct.sum())} direct), "
         f"{rows.size} SA rows located, bit-equal to FMIndexNumpy; "
         f"set-up {t_setup:.1f} s, seed+locate {t_run:.1f} s incl. "
         f"compiles. Cut: the text is below 2^31 positions; no >=2^31 "
         f"text ran on the card")


def _records(path: str, bam: bool):
    """(header, records) of a SAM or BAM file."""
    if bam:
        sys.path.insert(0, os.path.join(HERE, "tests"))
        from test_bam import decode_bam

        header, refs, recs = decode_bam(path)
        return (header, refs), recs
    head, recs = [], []
    with open(path, errors="replace") as f:
        for line in f:
            (head if line.startswith("@") else recs).append(line)
    return head, recs


def child_compare(args) -> None:
    man = _manifest(args.work)
    for cname in args.rest:
        ds = man[cname]
        got_p, got_sj = _outputs(ds, "jax")
        want_p, want_sj = _outputs(ds, "numpy")
        gh, got = _records(got_p, ds["bam"])
        wh, want = _records(want_p, ds["bam"])
        same = sum(1 for a, b in zip(got, want) if a == b)
        with open(got_sj) as f:
            sj_got = f.read().splitlines()
        with open(want_sj) as f:
            sj_want = f.read().splitlines()
        sj_same = sum(1 for a, b in zip(sj_got, sj_want) if a == b)
        kind = "BAM records (decoded)" if ds["bam"] else "SAM records"
        info(f"{cname}: {same}/{max(len(got), len(want))} {kind} identical "
             f"in order to the --engine numpy oracle; junctions "
             f"{sj_same}/{max(len(sj_got), len(sj_want))} identical; "
             f"headers {'identical' if gh == wh else 'DIFFER'}")
        if (gh != wh or same != len(got) or len(got) != len(want)
                or len(got) == 0 or sj_got != sj_want):
            raise SmokeFailure(f"{cname}: output differs from the oracle")


def child_multi_cli(args) -> None:
    from dart_tpu import cli

    tag, extra = args.rest[0], args.rest[1:]
    ds = _manifest(args.work)["50mbp_se"]
    t0 = time.time()
    rc = cli.main(_cli_argv(ds, f"multi-{tag}", "--engine", "jax",
                            "-silent", *extra))
    if rc != 0:
        raise SmokeFailure(f"{tag} exited with {rc}")
    what = f"pid {extra[-1]}" if tag == "dist" else " ".join(extra)
    info(f"multi {tag} {what}: {time.time() - t0:.1f} s "
         f"incl. index load and compiles")


def child_multi_compare(args) -> None:
    ds = _manifest(args.work)["50mbp_se"]
    want = [open(p, "rb").read() for p in _outputs(ds, "multi-one")]
    n = want[0].count(b"\n")
    for tag in ("mesh-data4", "mesh-data2-index2", "dist"):
        got = [open(p, "rb").read() for p in _outputs(ds, f"multi-{tag}")]
        if got != want:
            raise SmokeFailure(f"{tag}: output differs from one card")
        info(f"multi {tag}: SAM ({n} lines) and junctions byte-identical "
             f"to the one-card run")


CHILDREN = {
    "device": child_device, "native": child_native,
    "gpu-tests": child_gpu_tests, "data": child_data,
    "oracle": child_oracle, "align": child_align,
    "wide-oracle": child_wide_oracle, "wide": child_wide,
    "compare": child_compare, "multi-cli": child_multi_cli,
    "multi-compare": child_multi_compare,
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="four cards: the mesh and multi-process paths")
    ap.add_argument("--seed", type=int, default=20260816,
                    help="seed of the synthetic genomes and reads")
    ap.add_argument("--rehearse", action="store_true",
                    help="CPU backend, small data; no ok line")
    ap.add_argument("--child", choices=sorted(CHILDREN),
                    help=argparse.SUPPRESS)
    args, rest = ap.parse_known_args()
    args.rest = rest
    if not os.path.isdir(os.path.join(HERE, "dart_tpu")):
        print("chip_smoke.py must run from a checkout of the repository "
              "(dart_tpu/ not found beside it)", file=sys.stderr)
        return 2
    if args.child:
        args.work = os.path.join(
            HERE, ".smoke_data",
            f"{'rehearse' if args.rehearse else 'full'}-{args.seed}")
        CHILDREN[args.child](args)
        return 0
    plats = os.environ.get("JAX_PLATFORMS", "")
    if not args.rehearse and plats and "cuda" not in plats \
            and "gpu" not in plats:
        print(f"JAX_PLATFORMS={plats} excludes the GPU this script runs "
              "on", file=sys.stderr)
        return 2
    if not args.rehearse and shutil.which("nvidia-smi") is None:
        print("nvidia-smi not found: no NVIDIA GPU on this machine",
              file=sys.stderr)
        return 2
    smoke = Smoke(args)
    try:
        smoke.multi() if args.multi else smoke.single()
    except SmokeFailure as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        smoke.stop_all()
    return 0


if __name__ == "__main__":
    sys.exit(main())
