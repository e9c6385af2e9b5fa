"""The PyTorch port as a package: imports, device policy, configuration."""

import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from torch_port_util import SMALL

torch.set_num_threads(1)

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
    from vectorquantizedcpc_tpu_torch.configs import load_conf

    def compare(ours, theirs, path):
        for f in dataclasses.fields(ours):
            a, b = getattr(ours, f.name), getattr(theirs, f.name)
            if dataclasses.is_dataclass(a):
                compare(a, b, f"{path}.{f.name}")
            else:
                assert a == b, f"{path}.{f.name}: {a!r} != {b!r}"

    compare(load_conf(list(argv)), jax_load(list(argv)), "")


@pytest.mark.parametrize(
    "argv, match",
    [
        (["training_vocoder.trainer.max_epochs=5"], "Unknown config key"),
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
    from vectorquantizedcpc_tpu_torch.ops.ar_decode import resolve_precision

    for p in ("bfloat16", "bf16", "float32"):
        assert resolve_precision(p) == "bf16"
    for p in ("int8", "auto"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            resolve_precision(p)
    with pytest.raises(ValueError, match="precision"):
        resolve_precision("fp8")
