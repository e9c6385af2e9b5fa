"""The PyTorch port as a package: imports, device policy, configuration."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from torch_port_util import SMALL, module_time_limit, time_limit  # noqa: F401

torch.set_num_threads(1)
TIME_LIMIT_S = 120  # each test's own limit (torch_port_util.time_limit)

PKG = Path(__file__).resolve().parents[1] / "vectorquantizedcpc_tpu_torch"


def _modules():
    return sorted(
        "vectorquantizedcpc_tpu_torch."
        + ".".join(p.relative_to(PKG).with_suffix("").parts)
        for p in PKG.rglob("*.py")
        if p.name != "__init__.py"
    )


def test_imports_without_jax_or_the_jax_package():
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "sys.modules['vectorquantizedcpc_tpu'] = None\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=PKG.parent,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_imports_without_msgpack_or_yaml():
    """The card's machine has neither: the port decodes checkpoints and
    reads YAML itself (utils/msgpack.py, utils/yaml_subset.py)."""
    code = (
        "import sys, importlib\n"
        "for name in ('msgpack', 'yaml', 'jax', 'flax', 'vectorquantizedcpc_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "print('ok')\n"
    )
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=PKG.parent,
        capture_output=True, text=True, timeout=120,
    )
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_source_names_no_msgpack_or_yaml_import():
    bad = re.compile(r"^\s*(import|from)\s+(msgpack|yaml|flax|jax)(\.|\s|$)", re.M)
    for path in list(PKG.rglob("*.py")) + [PKG.parent / "chip_smoke.py"]:
        hits = bad.findall(path.read_text())
        assert not hits, f"{path.name} imports {hits}"


def test_source_names_no_jax_import():
    bad = re.compile(
        r"^\s*(import|from)\s+(jax|flax|vectorquantizedcpc_tpu)(\.|\s|$)", re.M
    )
    for path in PKG.rglob("*.py"):
        hits = bad.findall(path.read_text())
        assert not hits, f"{path.name} imports {hits}"


def test_entry_points_raise_without_a_card(monkeypatch, tmp_path):
    from vectorquantizedcpc_tpu_torch.configs import load_conf
    from vectorquantizedcpc_tpu_torch.device import resolve_device
    from vectorquantizedcpc_tpu_torch.infer.convert import convert

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="runtime.platform=cpu"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unknown platform"):
        resolve_device("tpu")
    conf = load_conf([f"in_dir={tmp_path}", f"synthesis_list={tmp_path}/x.json"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        convert(conf)


@pytest.mark.parametrize(
    "argv",
    [
        [],
        SMALL,
        ["bit_mulaw=10", "sampling_rate=22050", "runtime.precision=float32"],
    ],
)
def test_config_matches_the_jax_config(argv):
    """Every key of the port's config has the JAX config's value."""
    import dataclasses

    from vectorquantizedcpc_tpu.configs import load_conf as jax_load
    from vectorquantizedcpc_tpu_torch.configs import PORT_ONLY_KEYS, load_conf

    def compare(ours, theirs, path):
        for f in dataclasses.fields(ours):
            if f"{path}.{f.name}"[1:] in PORT_ONLY_KEYS:  # at its default, the JAX model
                assert getattr(ours, f.name) == f.default
                continue
            a, b = getattr(ours, f.name), getattr(theirs, f.name)
            if dataclasses.is_dataclass(a):
                compare(a, b, f"{path}.{f.name}")
            else:
                assert a == b, f"{path}.{f.name}: {a!r} != {b!r}"

    compare(load_conf(list(argv)), jax_load(list(argv)), "")


@pytest.mark.parametrize(
    "argv, match",
    [
        (["training_vocoder.trainer.max_epoch=5"], "Unknown config key"),
        (["model.encoder.chanels=5"], "Unknown config key"),
        (["dim_latent=abc"], "Expected int"),
        (["runtime.platform"], "key=value"),
        (["model.encoder=3"], "Expected mapping"),
    ],
)
def test_config_rejects_bad_overrides(argv, match):
    from vectorquantizedcpc_tpu_torch.configs import load_conf

    with pytest.raises(ValueError, match=match):
        load_conf(argv)


def test_precision_modes():
    from vectorquantizedcpc_tpu_torch.ops.ar_decode import _STEP_US, _interp_step_us, resolve_precision

    for p in ("bfloat16", "bf16", "float32"):
        assert resolve_precision(p) == "bf16"
    assert resolve_precision("int8", 8) == "int8"
    for batch in (1, 8, 64, 128):  # auto: the faster mode of the table at the batch
        faster = min(("bf16", "int8"), key=lambda m: (_interp_step_us(_STEP_US[m], batch), m))
        assert resolve_precision("auto", batch, _STEP_US) == faster
    with pytest.raises(ValueError, match="precision"):
        resolve_precision("fp8")



@pytest.mark.parametrize("tensor, match", [
    pytest.param(lambda: torch.zeros(2, 3, device="meta"), r"x is on meta, ref on cpu", id="device"),
    pytest.param(lambda: torch.zeros(2, 3, dtype=torch.bfloat16),
                 r"x: expected torch\.float32 \(2, 3\), got torch\.bfloat16 \(2, 3\)", id="dtype"),
    pytest.param(lambda: torch.zeros(3, 2),
                 r"x: expected torch\.float32 \(2, 3\), got torch\.float32 \(3, 2\)", id="shape"),
    pytest.param(lambda: torch.zeros(3, 2).t(), r"x must be contiguous", id="contiguity"),
    pytest.param(lambda: torch.zeros(2, 3), None, id="taken"),
])
def test_expect_tensors_refuses_what_a_kernel_does_not_take(tensor, match):
    """The kernels' one contract check (ops/_build.py:expect_tensors):
    device, dtype, shape and contiguity, each named in its refusal."""
    from vectorquantizedcpc_tpu_torch.ops._build import expect_tensors

    right = (torch.float32, (2, 3))
    tensors = {"ok": (torch.zeros(2, 3), *right), "x": (tensor(), *right)}
    if match is None:
        expect_tensors(tensors, torch.device("cpu"), "ref")
        return
    with pytest.raises(ValueError, match=match):
        expect_tensors(tensors, torch.device("cpu"), "ref")
