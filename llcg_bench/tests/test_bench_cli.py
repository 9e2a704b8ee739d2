"""The command refuses to run where it may not: without a card, and in a
directory that holds only the benchmark's own files."""
import pathlib
import shutil
import subprocess
import sys

from llcg_bench import run

ROOT = pathlib.Path(__file__).resolve().parents[2]


def test_no_card_no_result(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "reddit-sage.llcg", "--seed", "1",
                   "--seconds", "1", "--trace", "0"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA" in out.err


def test_benchmark_files_alone_do_not_run(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "llcg_bench", tmp_path / "llcg_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = subprocess.run([sys.executable, "-m", "llcg_bench.run",
                        "--workload", "reddit-sage.llcg", "--seed", "1",
                        "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=300,
                       env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert p.returncode != 0 and p.stdout == ""
