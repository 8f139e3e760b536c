"""On the card: the benchmark's ranges around the kernel entry points
hold the kernels' device time, so a roofline share is read and lies
under 100 %; skipped without a card."""
import pytest
import torch

from portbench import run as R
from portbench.tests.conftest import tiny_serve, tiny_train


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return "cuda"


@pytest.mark.gpu
@pytest.mark.parametrize("which", ["serve", "train"])
def test_rooflines_on_the_card(manifest, card, which):
    from portbench.manifest import load_reader
    conf, traffic, limits = (tiny_serve if which == "serve"
                             else tiny_train)(manifest)
    if which == "train":
        # K6's mma body: a head dim of 64
        conf = dict(conf, hidden_size=512, num_attention_heads=8,
                    num_key_value_heads=2, attention_multiplier=64 ** -0.5)
    names = (("k1_roofline", "k2_roofline") if which == "serve"
             else ("k6_fwd_roofline", "k6_bwd_roofline"))
    out = R.run_cell(conf, traffic, limits, seed=1, seconds=1.0, trace=True,
                     device=card, readers=names)
    assert out["correct"], out["verdict"]
    for name in names:
        value = load_reader(name).read(out["run"])
        assert value is not None and 0 < value <= 100, (name, value)
