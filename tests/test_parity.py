"""End-to-end output parity: our aligner vs committed golden outputs
produced by the reference dart binary (bit-for-bit, -t 1 determinism).

Note the goldens include 5 half-mapped pairs (c5/c6/c7, FLAGs
105/149) matched bit-for-bit with NO normalization — the reference's
intended half-mapped flags, which pipeline/report.py ports exactly
and bench.py's normalizer targets (tests/test_bench_parity.py)."""

import io

import pytest

from dart_tpu.aligner import DartAligner
from dart_tpu.config import DartConfig

CONFIGS = {
    "c1_se_exact": dict(r1=["se_exact.fa"]),
    "c2_se_mm": dict(r1=["se_mm.fq"], mis=5),
    "c3_spliced": dict(r1=["spliced.fa"]),
    "c4_spliced_mm": dict(r1=["spliced_mm.fq"], mis=5, all_sj=True),
    "c5_pe": dict(r1=["pe_1.fq"], r2=["pe_2.fq"], mis=5),
    "c6_pe_gz": dict(r1=["pe_1.fq.gz"], r2=["pe_2.fq.gz"], mis=5),
    "c7_pe_inter": dict(r1=["pe_inter.fq"], p=True, mis=5),
    "c8_multi": dict(r1=["se_exact.fa"], m=True),
    "c9_unique": dict(r1=["se_mm.fq"], unique=True, mis=5),
}


def run_config(name, spec, toy_index, data_dir, tmp_path, engine="numpy"):
    cfg = DartConfig()
    cfg.read_files_1 = [str(data_dir / f) for f in spec["r1"]]
    cfg.read_files_2 = [str(data_dir / f) for f in spec.get("r2", [])]
    cfg.max_mismatch = spec.get("mis", 0)
    cfg.pair_end = spec.get("p", False)
    cfg.multi_hit = spec.get("m", False)
    cfg.unique_only = spec.get("unique", False)
    cfg.find_all_junction = spec.get("all_sj", False)
    cfg.sj_file = str(tmp_path / f"{name}.tab")
    cfg.output_file = str(tmp_path / f"{name}.sam")
    cfg.silent = True
    cfg.engine = engine
    out = io.StringIO()
    aligner = DartAligner(toy_index, cfg)
    aligner.run(out_stream=out)
    return out.getvalue(), (tmp_path / f"{name}.tab").read_text()


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_output_parity(name, toy_index, data_dir, golden_dir, tmp_path, capsys):
    sam, sj = run_config(name, CONFIGS[name], toy_index, data_dir, tmp_path)
    golden_sam = (golden_dir / f"{name}.sam").read_text()
    golden_sj = (golden_dir / f"{name}.junctions.tab").read_text()
    assert sam == golden_sam, f"SAM mismatch for {name}"
    assert sj == golden_sj, f"junction table mismatch for {name}"


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_output_parity_jax_engine(name, toy_index, data_dir, golden_dir, tmp_path, capsys):
    """Same bit-for-bit outputs when the device (JAX) engine computes
    the MEM walks and SA locates — every golden config, since jax is
    the default engine (config.engine == "auto" resolves to jax)."""
    sam, sj = run_config(name, CONFIGS[name], toy_index, data_dir, tmp_path,
                         engine="jax")
    assert sam == (golden_dir / f"{name}.sam").read_text()
    assert sj == (golden_dir / f"{name}.junctions.tab").read_text()


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_output_parity_gpu(name, gpu, toy_index, data_dir, golden_dir,
                           tmp_path, capsys):
    """Every golden config through the jax engine with its tables on the
    GPU: bit-for-bit the reference's output."""
    import jax

    assert jax.default_backend() == "gpu"
    sam, sj = run_config(name, CONFIGS[name], toy_index, data_dir, tmp_path,
                         engine="jax")
    assert sam == (golden_dir / f"{name}.sam").read_text()
    assert sj == (golden_dir / f"{name}.junctions.tab").read_text()


@pytest.mark.parametrize("name", ["c3_spliced", "c5_pe"])
def test_output_parity_python_pipeline(name, toy_index, data_dir, golden_dir,
                                       tmp_path, capsys):
    """The pure-Python pipeline (the parity oracle / -d path) must stay
    bit-identical to the native pipeline and the goldens."""
    spec = dict(CONFIGS[name])
    cfg_patch = dict(spec)
    sam, sj = run_config(name, cfg_patch, toy_index, data_dir, tmp_path,
                         engine="numpy")
    # force the python path via a fresh run with native disabled
    cfg = DartConfig()
    cfg.read_files_1 = [str(data_dir / f) for f in spec["r1"]]
    cfg.read_files_2 = [str(data_dir / f) for f in spec.get("r2", [])]
    cfg.max_mismatch = spec.get("mis", 0)
    cfg.native = False
    cfg.sj_file = str(tmp_path / f"{name}_py.tab")
    cfg.output_file = str(tmp_path / f"{name}_py.sam")
    cfg.silent = True
    import io

    out = io.StringIO()
    from dart_tpu.aligner import DartAligner

    aligner = DartAligner(toy_index, cfg)
    assert aligner.native is None
    aligner.run(out_stream=out)
    assert out.getvalue() == (golden_dir / f"{name}.sam").read_text()
    assert (tmp_path / f"{name}_py.tab").read_text() == \
        (golden_dir / f"{name}.junctions.tab").read_text()
