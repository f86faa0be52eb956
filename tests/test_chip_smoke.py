"""chip_smoke.py on the CPU: its inputs, its tree comparison, one small
parity round, and its refusal to run without a GPU."""

import os
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

SMALL = dict(genome_bp=30_000, n_duk=300, n_pairs=120, n_map=200,
             coverage=4)


@pytest.fixture(scope="module")
def small_inputs(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("smoke") / "inputs")
    n_planted = chip_smoke.gen_inputs(d, **SMALL)
    return d, n_planted


def _fastq_records(path):
    with open(path, "rb") as fh:
        lines = fh.read().split(b"\n")
    return [lines[i : i + 4] for i in range(0, len(lines) - 1, 4)]


@pytest.mark.parametrize(
    "name,n", [("reads.fq", 300), ("r1.fq", 120), ("r2.fq", 120),
               ("map.fq", 200), ("asm.fq", 4 * 30_000 // 151)],
)
def test_gen_inputs_shapes(small_inputs, name, n):
    d, _ = small_inputs
    recs = _fastq_records(os.path.join(d, name))
    assert len(recs) == n
    assert all(len(r[1]) == chip_smoke.READ_LEN == len(r[3]) for r in recs)
    assert all(set(r[1]) <= set(b"ACGTN") for r in recs)


def test_gen_inputs_truth(small_inputs):
    """Adapters sit in every third bbduk read, pairs carry their insert,
    and the truth VCF lists SNPs of the reference it names."""
    d, n_planted = small_inputs
    recs = _fastq_records(os.path.join(d, "reads.fq"))
    assert n_planted == 100
    # planted at 60..139, so at least the first 12 adapter bases fit
    assert all(chip_smoke.ADAPTER[:12] in r[1] for r in recs[::3])
    r1 = _fastq_records(os.path.join(d, "r1.fq"))
    r2 = _fastq_records(os.path.join(d, "r2.fq"))
    comp = bytes.maketrans(b"ACGT", b"TGCA")
    for a, b in zip(r1[:20], r2[:20]):
        ins = int(a[0].split(b"_insert")[1].split()[0])
        assert 180 <= ins < 280
        # r2 is the reverse complement of the insert's last 151 bases:
        # the two overlap by 2 * 151 - ins bases
        ov = 2 * chip_smoke.READ_LEN - ins
        assert a[1][-ov:] == b[1][::-1].translate(comp)[:ov]
    with open(os.path.join(d, "asm_ref.fa"), "rb") as fh:
        assert len(fh.read().split(b"\n")[1]) == SMALL["genome_bp"]
    with open(os.path.join(d, "truth.vcf")) as fh:
        snps = [ln.split("\t") for ln in fh if not ln.startswith("#")]
    assert 0 < len(snps) < 30_000 * 0.01
    assert all(s[0] == "scaffold_0" and s[3] != s[4] for s in snps)


def test_compare_trees(tmp_path, capsys):
    """Only the path-bearing header lines are ignored; any other byte,
    or a file on one side only, fails the comparison."""
    a, b = tmp_path / "a", tmp_path / "b"
    for d, tag in ((a, b"/x"), (b, b"/y")):
        (d / "inputs").mkdir(parents=True)
        (d / "inputs" / "ignored.fq").write_bytes(tag)
        (d / "m.sam").write_bytes(b"@PG\tCL:" + tag + b"\nr1\t0\n")
        (d / "s.txt").write_bytes(b"#File\t" + tag + b"\n1\t2\n")
    assert chip_smoke.compare_trees(str(a), str(b))
    (b / "s.txt").write_bytes(b"#File\t/y\n1\t3\n")
    assert not chip_smoke.compare_trees(str(a), str(b))
    (b / "s.txt").write_bytes(b"#File\t/y\n1\t2\n")
    (b / "extra.fa").write_bytes(b">c\n")
    assert not chip_smoke.compare_trees(str(a), str(b))
    assert "MISSING" in capsys.readouterr().out


@pytest.mark.parametrize(
    "contigs,covered",
    [([b"ACGTTGCA"], 0.5), ([b"TTACGTTTTG", b"ACGTTG"], 1.0),
     ([b"CGTTGCAAAACGT"], 13 / 16), ([b"ACGTTGCC"], None),
     ([b"ACGTTGCA", b"GGGG"], None)],
)
def test_grade_assembly(tmp_path, contigs, covered):
    """Contigs must lie exactly on the region, on either strand; the
    grade is the share of the region they cover."""
    region = tmp_path / "asm_ref.fa"
    region.write_bytes(b">asm\nACGTTGCAAAACGTAA\n")
    fa = tmp_path / "contigs.fa"
    fa.write_bytes(b"".join(b">c%d\n%s\n" % (i, c)
                            for i, c in enumerate(contigs)))
    if covered is None:
        with pytest.raises(AssertionError, match="not in the assembled"):
            chip_smoke.grade_assembly(str(fa), str(region))
    else:
        share, depth = chip_smoke.grade_assembly(str(fa), str(region))
        assert share == covered
        assert depth == sum(map(len, contigs)) / 16


def test_pipelines_and_parity_round(small_inputs, tmp_path):
    """The six pipelines run on the small inputs; a second round over a
    subset reproduces the first round's subset outputs byte for byte."""
    d, _ = small_inputs
    sub = str(tmp_path / "sub" / "inputs")
    chip_smoke.subset_inputs(d, sub, n_reads=150, n_pairs=60)
    assert len(_fastq_records(os.path.join(sub, "map.fq"))) == 150
    secs = chip_smoke.run_pipelines(sub, str(tmp_path / "sub" / "a"))
    assert set(secs) == set(chip_smoke.PIPELINES)
    chip_smoke.run_pipelines(sub, str(tmp_path / "sub" / "b"))
    assert chip_smoke.compare_trees(
        str(tmp_path / "sub" / "a"), str(tmp_path / "sub" / "b")
    )
    names = sorted(os.listdir(tmp_path / "sub" / "a"))
    assert names == sorted([
        "bbduk.fq", "bbduk_stats.txt", "khist.txt", "peaks.txt",
        "merged.fq", "unmerged.fq", "ihist.txt", "mapped.sam",
        "vars.vcf", "contigs.fa",
    ])


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_refuses_to_run_without_gpu(script, tmp_path):
    """Without a GPU both scripts exit non-zero and print no result."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    res = subprocess.run(
        [sys.executable, os.path.join(ROOT, script)], env=env,
        capture_output=True, text=True, timeout=300, cwd=str(tmp_path),
    )
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_multi_phase_on_virtual_devices(tmp_path, capsys):
    """--multi's five sharded runs, each byte-equal to its one-device
    run, on four of the CPU test mesh's virtual devices."""
    chip_smoke.phase_multi(str(tmp_path), "cpu", genome_bp=30_000,
                           n_reads=300, n_pairs=120, asm_bp=3_000)
    out = capsys.readouterr().out
    assert out.count("PARITY_OK") == 5
    for name in ("bbduk", "kmercountexact", "bbmap", "bbmerge", "tadpole"):
        assert f"{name} many" in out
