"""CPU checks of the measurement scripts at the repo root: chip_smoke.py's
phase selection and HLO reading, bench.py's peak table, and the
device-capacity gates the colorers size their adjacency by."""

import importlib.util
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_root_module(name):
    """Import ``<repo>/<name>.py`` by path (the scripts are not a package)."""
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, f"{name}.py")
    )
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize(
    "argv, phases, count",
    [
        ([], ["nc", "resident", "gather"], 1),
        (["--multi"], ["multi"], 4),
    ],
)
def test_chip_smoke_phase_selection(monkeypatch, capsys, argv, phases,
                                    count):
    """--multi runs only the four-card phase; the default run only the
    one-card phases; the last line is the device JSON."""
    cs = load_root_module("chip_smoke")
    ran = []
    dev = {"platform": "gpu", "kind": "Fake GPU", "count": count,
           "nvidia_smi": "Fake GPU, 700.00 W"}
    monkeypatch.setattr(cs, "phase_device", lambda n: ran.append(n) or dev)
    for ph in ("nc", "resident", "gather", "multi"):
        monkeypatch.setattr(
            cs, f"phase_{ph}", lambda *a, _p=ph, **k: ran.append(_p)
        )
    monkeypatch.setattr(cs, "CompileTimer", lambda: None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "unused")
    assert cs.main(argv) == 0
    assert ran == [count] + phases
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[-2] == dev["nvidia_smi"]
    assert json.loads(lines[-1]) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "Fake GPU", "count": count},
    }


def test_chip_smoke_refuses_cpu():
    """Without a GPU the device phase exits non-zero before any work."""
    cs = load_root_module("chip_smoke")
    with pytest.raises(SystemExit) as e:
        cs.phase_device(1)
    assert "no GPU" in str(e.value)


_CUBLAS = 'custom-call(%a, %b), custom_call_target="__cublas$gemm"'
_TRITON = """%fused_dot (p0: u32[8,128]) -> s32[8,8] {
  %s = u32[8,128] shift-right-logical(%p0, %c)
  ROOT %d = s32[8,8] dot(%x, %y)
}

ENTRY %main {
  %f = s32[8,8] fusion(%a), kind=kCustom, calls=%fused_dot, backend_config={"fusion_backend_config":{"kind":"__triton_gemm"}}
}"""


@pytest.mark.parametrize(
    "hlo, want",
    [
        (_CUBLAS, ("cublas", False)),
        (_TRITON, ("triton_gemm", True)),
        (_TRITON.replace("shift-right-logical", "add"),
         ("triton_gemm", False)),
        ("ENTRY %main { ROOT %d = s32[8,8] dot(%x, %y) }",
         ("other", False)),
    ],
)
def test_gemm_route(hlo, want):
    assert load_root_module("chip_smoke").gemm_route(hlo) == want


def test_peak_table():
    """Peaks come from one table keyed by device_kind; an unknown device
    is an error, not a default."""
    bench = load_root_module("bench")
    h100 = bench.peak_for("NVIDIA H100 80GB HBM3")
    assert h100["int8_ops_s"] == 1979e12 and "data sheet" in h100["source"]
    with pytest.raises(ValueError, match="no published peak"):
        bench.peak_for("Some Other Accelerator")


@pytest.mark.parametrize(
    "capacity, dense_max, packed_max",
    [
        # 16 GiB: just above the fixed 102,400 / 286,720 caps the gates
        # replaced
        (16 * 1024**3, 103_552, 291_200),
        (80 * 10**9, 223_488, 630_784),
    ],
)
def test_capacity_derived_caps(capacity, dense_max, packed_max):
    """The adjacency caps follow the capacity they are given: the largest
    128-multiple n_pad whose dense / packed adjacency fits."""
    from mcmc_colorer_tpu.ops.dense_adj import (
        adjacency_fits,
        dense_adj_bytes,
        matmul_adjacency_kind,
        packed_adj_bytes,
        require_packed_fits,
    )

    def largest(nbytes):
        n = 128
        while adjacency_fits(nbytes(n + 128), capacity):
            n += 128
        return n

    assert largest(dense_adj_bytes) == dense_max
    assert largest(packed_adj_bytes) == packed_max
    assert matmul_adjacency_kind(dense_max, capacity=capacity) == "dense"
    assert (
        matmul_adjacency_kind(dense_max + 128, capacity=capacity)
        == "packed"
    )
    assert (
        matmul_adjacency_kind(dense_max, True, capacity=capacity)
        == "packed"
    )
    require_packed_fits(packed_max, capacity)
    with pytest.raises(ValueError, match="packed-adjacency memory cap"):
        require_packed_fits(packed_max + 128, capacity)
    with pytest.raises(ValueError, match="even the bit-packed"):
        matmul_adjacency_kind(packed_max + 128, capacity=capacity)


def test_device_capacity_cpu():
    """The CPU backend reports no allocator limit: its capacity is the
    host's physical memory."""
    from mcmc_colorer_tpu.ops.dense_adj import device_capacity

    host = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    assert device_capacity() == host
