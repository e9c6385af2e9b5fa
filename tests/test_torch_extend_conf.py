"""``path_extend_conf=<yaml>`` in the port's config, and its YAML parser against PyYAML.

The port reads YAML with ``utils/yaml_subset.py`` (the card's machine has no
PyYAML). It must give what ``yaml.safe_load`` gives on the JAX package's
``CONF_DEFAULT_STR``, on hypothesis-made config trees written in block and
flow style, and on raw plain scalars (YAML 1.1's resolver: ``yes``, ``on``,
``1e3``, ``0o17``, ``017``, ``1:30``); ``load_conf`` must merge a file as
the JAX package's does (CLI > file > defaults, links resolved after both)
and raise on keys the port lacks and on YAML beyond the subset.
"""

import dataclasses
import datetime
import math

import pytest
import yaml
from hypothesis import HealthCheck, assume, example, given, settings
from hypothesis import strategies as st

from vectorquantizedcpc_tpu import configs as jax_configs
from vectorquantizedcpc_tpu_torch import configs
from vectorquantizedcpc_tpu_torch.utils.yaml_subset import load_value, safe_load
from torch_port_util import module_time_limit, time_limit  # noqa: F401

TIME_LIMIT_S = 60  # each test's own limit (torch_port_util.time_limit)

INF = float("inf")


def _same(a, b) -> bool:
    if isinstance(b, float) and math.isnan(b):
        return isinstance(a, float) and math.isnan(a)
    if isinstance(b, list):
        return isinstance(a, list) and len(a) == len(b) and all(map(_same, a, b))
    if isinstance(b, dict):
        return isinstance(a, dict) and a.keys() == b.keys() and all(_same(a[k], b[k]) for k in b)
    return type(a) is type(b) and a == b


def test_jax_default_config_parses_as_pyyaml():
    assert _same(safe_load(jax_configs.CONF_DEFAULT_STR),
                 yaml.safe_load(jax_configs.CONF_DEFAULT_STR))


keys = st.from_regex(r"[a-z][a-z0-9_]{0,8}", fullmatch=True).filter(
    lambda k: yaml.safe_load(k) == k)
config_scalars = st.one_of(
    st.none(), st.booleans(), st.integers(-10 ** 12, 10 ** 12),
    st.floats(allow_nan=False, width=64),
    st.text(st.characters(min_codepoint=32, max_codepoint=126), max_size=16),
)
config_trees = st.recursive(
    st.dictionaries(keys, st.one_of(config_scalars, st.lists(config_scalars, max_size=5)),
                    min_size=1, max_size=6),
    lambda inner: st.dictionaries(keys, st.one_of(config_scalars, inner), min_size=1,
                                  max_size=5),
    max_leaves=30,
)


def _flow_style(tree: dict, indent: int = 0) -> str:
    """Block mappings whose lists are flow lists ``[a, b]``."""
    lines = []
    for k, v in tree.items():
        pad = " " * indent
        if isinstance(v, dict):
            lines.append(f"{pad}{k}:  # a comment")
            lines.append(_flow_style(v, indent + 4))
        elif isinstance(v, list):
            lines.append(f"{pad}{k}: " + yaml.safe_dump(v, default_flow_style=True,
                                                        width=INF).strip())
        else:
            lines.append(f"{pad}{k}: " + yaml.safe_dump([v], default_flow_style=True,
                                                        width=INF).strip()[1:-1])
    return "\n".join(lines)


@settings(max_examples=150, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(tree=config_trees)
@example(tree={"a": '0,"'})  # a quote after a comma outside a flow list is plain text
def test_config_trees_parse_as_pyyaml(tree):
    block = yaml.safe_dump(tree, default_flow_style=False, width=INF, sort_keys=False)
    flow = _flow_style(tree) + "\n"
    for text in (block, flow, "---\n" + block):
        assert _same(safe_load(text), yaml.safe_load(text)), text


# Plain scalars the resolver must treat as PyYAML does.
raw_tokens = st.one_of(
    st.sampled_from(["yes", "No", "ON", "off", "y", "n", "True", "FALSE", "~", "null", "Null",
                     "1e3", "1.0e5", "1.0e+5", "1.5e-3", "0o17", "017", "08", "0x1F", "0b101",
                     "1_000", "+1", "-0", ".5", "-.5", "+.5", "1.", "1:30", "1:30.5", "-1:02:03",
                     ".inf", "-.Inf", ".NaN", "nan", "inf", "0.", "00", "0_7", "1__2", "+0x_a"]),
    st.from_regex(r"[-+]?[0-9_.:xobeEa-fA-F]{1,8}", fullmatch=True),
    st.from_regex(r"[a-zA-Z~][a-zA-Z0-9_.~-]{0,6}", fullmatch=True),
)


def _pyyaml_scalar(text):
    try:
        value = yaml.safe_load(text)
    except (yaml.YAMLError, ValueError):
        return None
    return value


@settings(max_examples=400, deadline=None)
@given(tokens=st.lists(raw_tokens, min_size=1, max_size=4))
def test_plain_scalars_resolve_as_pyyaml(tokens):
    """One token as a value, the same tokens as a flow list and as a block
    sequence: where PyYAML makes scalars of them (no timestamp), the parser
    makes the same ones."""
    texts = [f"k: {tokens[0]}\n", f"k: [{', '.join(tokens)}]\n",
             "k:\n" + "".join(f"- {t}\n" for t in tokens)]
    for text in texts:
        want = _pyyaml_scalar(text)
        assume(isinstance(want, dict))
        values = want["k"] if isinstance(want["k"], list) else [want["k"]]
        assume(not any(isinstance(v, (datetime.date, list, dict)) for v in values))
        assert _same(safe_load(text), want), text
    assert _same(load_value(tokens[0]), yaml.safe_load(tokens[0]))


@pytest.mark.parametrize("text, line", [
    ("a: 1\nb: &anchor 2\n", 2),
    ("a: 1\nb: *alias\n", 2),
    ("a: !!int 3\n", 1),
    ("a:\n  b: |\n    text\n", 2),
    ("a: >\n  folded\n", 1),
    ("a: {b: 1}\n", 1),
    ("a: [1, {b: 2}]\n", 1),
    ("? complex\n: key\n", 1),
    ("%YAML 1.1\n---\na: 1\n", 1),
    ("a: 1\n---\nb: 2\n", 2),
    ("a: 1\n...\n", 2),
    ("a: 'open\n", 1),
    ("a: [1, 2\n", 1),
    ("a: 2024-01-31\n", 1),
    ("a: 1\n  b: 2\n", 2),
    ("a:\n\t- 1\n", 2),
])
def test_beyond_the_subset_raises_naming_the_line(text, line):
    with pytest.raises(ValueError, match=f"YAML line {line}:"):
        safe_load(text)


EXTEND = """\
# A run's settings over the defaults (the JAX package's path_extend_conf).
dim_latent: 16
size_latent_codebook: 128
training:
    cpc:
        n_epochs: 40
        scheduler:
            milestones:
            - 20
            - 30
            initial_lr: 2.0e-5
training_vocoder:
    trainer:
        val_interval_epoch: 5
runtime:
    precision: float32
"""


def _compare(ours, theirs, path=""):
    for f in dataclasses.fields(ours):
        a, b = getattr(ours, f.name), getattr(theirs, f.name)
        if dataclasses.is_dataclass(a):
            _compare(a, b, f"{path}.{f.name}")
        else:
            assert a == b, f"{path}.{f.name}: {a!r} != {b!r}"


@pytest.mark.parametrize("cli", [
    [],
    ["dim_latent=32", "training.cpc.n_epochs=7"],
    ["training.cpc.scheduler.milestones=[4, 8]", "runtime.precision=bfloat16"],
])
def test_load_conf_matches_jax_with_an_extend_file(tmp_path, cli):
    """CLI > file > defaults in both packages, ``${}`` links resolved after
    both: every key of the port's config has the JAX config's value."""
    path = tmp_path / "extend.yaml"
    path.write_text(EXTEND)
    argv = [f"path_extend_conf={path}"] + cli
    ours, theirs = configs.load_conf(argv), jax_configs.load_conf(argv)
    _compare(ours, theirs)
    z = 32 if "dim_latent=32" in cli else 16
    assert ours.dim_latent == ours.model.encoder.z_dim == ours.model.cpc.z_dim == z
    assert ours.training.cpc.n_epochs == (7 if cli[1:2] == ["training.cpc.n_epochs=7"] else 40)
    assert ours.size_latent_codebook == ours.training_vocoder.model.network.size_i_codebook == 128


@pytest.mark.parametrize("value", ["yes", "1e-3", "0o17", "017", "[1, 0x10]", "~", "'quoted'"])
def test_cli_values_resolve_as_the_jax_cli(value):
    """The JAX CLI reads each value with yaml.safe_load; so does the port."""
    assert _same(configs.parse_cli_overrides([f"a.b={value}"]),
                 jax_configs.parse_cli_overrides([f"a.b={value}"]))


def test_jax_only_keys_are_the_jax_config_keys_the_port_lacks():
    def leaves(tree, prefix=""):
        out = set()
        for key, value in tree.items():
            out |= leaves(value, f"{prefix}{key}.") if isinstance(value, dict) else {prefix + key}
        return out

    theirs = leaves(yaml.safe_load(jax_configs.CONF_DEFAULT_STR))
    assert configs.JAX_ONLY_KEYS == theirs - leaves(configs.conf_default_tree())


@pytest.mark.parametrize("text, match", [
    ("runtime:\n    num_cpu_devices: 4\n",
     r"Unknown config key\(s\) at 'runtime': \['num_cpu_devices'\]; "
     r"\['runtime.num_cpu_devices'\] belong to the JAX package's config and are not ported"),
    ("runtime:\n    use_pallas: false\n", r"\['runtime.use_pallas'\] belong to the JAX"),
    ("dataset_name: ZR19\n", r"\['dataset_name'\] belong to the JAX package's config"),
    ("model:\n    encoder:\n        chanels: 5\n",
     r"Unknown config key\(s\) at 'model.encoder': \['chanels'\]$"),
    ("dim_latent: abc\n", "Expected int at 'dim_latent'"),
    ("model:\n    encoder: &e\n        channels: 5\n", "YAML line 2: an anchor"),
    ("- 1\n- 2\n", "the document is not a mapping"),
])
def test_extend_file_errors_name_the_key_or_line(tmp_path, text, match):
    path = tmp_path / "extend.yaml"
    path.write_text(text)
    with pytest.raises(ValueError, match=match):
        configs.load_conf([f"path_extend_conf={path}"])


def test_jax_only_key_on_the_cli_says_so():
    with pytest.raises(ValueError, match=r"\['runtime.num_cpu_devices'\] belong to the JAX"):
        configs.load_conf(["runtime.num_cpu_devices=4"])


def test_an_empty_extend_file_changes_nothing(tmp_path):
    path = tmp_path / "extend.yaml"
    path.write_text("# nothing\n\n")
    _compare(configs.load_conf([f"path_extend_conf={path}"]), configs.load_conf([]))
