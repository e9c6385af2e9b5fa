"""The port's preprocess CLI: where its features go.

An ``out_dir`` given on the command line or in a ``path_extend_conf`` file
wins, whatever its value; left out, the features go to the data root that
the trainers read (``data.dataset.adress_data_root``). The JAX CLI tells the
two apart by comparing the value with its default ``./out``, so an explicit
``out_dir=./out`` went to the data root there; the port repairs that.
"""

import pytest

from torch_port_util import module_time_limit, time_limit  # noqa: F401
from vectorquantizedcpc_tpu_torch.cli import preprocess
from vectorquantizedcpc_tpu_torch.data.corpus import SyntheticCorpus

TIME_LIMIT_S = 120.0


@pytest.fixture
def corpus_argv(tmp_path, monkeypatch):
    """A 2-speaker corpus of 0.25 s utterances, the run's working directory
    at ``tmp_path`` (``./out`` lies there) and a data root beside it."""
    SyntheticCorpus(tmp_path / "corpus", n_speakers=2, n_utterances=2, duration_s=0.25).utterances()
    monkeypatch.chdir(tmp_path)
    return tmp_path, ["data.dataset.name=synthetic", f"data.corpus.root={tmp_path / 'corpus'}",
                      f"data.dataset.adress_data_root={tmp_path / 'root'}",
                      "data.loader.num_workers=1"]


@pytest.mark.parametrize("how", ["command line", "path_extend_conf"])
def test_explicit_out_dir_wins_over_the_data_root(corpus_argv, how):
    d, argv = corpus_argv
    if how == "command line":
        argv = argv + ["out_dir=./out"]
    else:
        (d / "extend.yaml").write_text("out_dir: ./out\n")
        argv = argv + [f"path_extend_conf={d / 'extend.yaml'}"]
    assert preprocess.out_dir_given(argv)
    manifest = preprocess.main(argv)
    assert len(manifest["utterances"]) == 4
    assert (d / "out").is_dir() and any((d / "out").iterdir())
    assert not (d / "root").exists()


def test_default_out_dir_goes_to_the_data_root(corpus_argv):
    d, argv = corpus_argv
    assert not preprocess.out_dir_given(argv)
    manifest = preprocess.main(argv)
    assert len(manifest["utterances"]) == 4
    assert (d / "root").is_dir() and any((d / "root").iterdir())
    assert not (d / "out").exists()
