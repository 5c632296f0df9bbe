"""Twin of tests/test_arch_smoke.py's ``test_reduced_forward_and_decode``
over all ten architectures, on the CPU: each reduced config, with the
port's own parameters, runs a plain forward (whisper: its encoder and an
uncached decoder pass), a prefill and a decode step with finite logits of
the expected shapes. The reference's loss and train step have their twins
in tests/test_torch_train_families.py (loss and gradients of all ten
against ``repro``) and tests/test_torch_training.py (the step); the other
``test_torch_*`` files hold each family to the JAX package."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import ARCH_IDS, get_reduced  # noqa: E402
from repro_torch.models import build_model, encdec, transformer  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# each architecture as its reduced config has it; and qwen1.5-32b with
# the int8 KV cache its full config serves with (its reduced one has bf16)
CASES = [(a, {}) for a in ARCH_IDS] + [("qwen1.5-32b",
                                        {"kv_cache_dtype": "int8"})]


@pytest.mark.parametrize("arch,replace", CASES,
                         ids=[*ARCH_IDS, "qwen1.5-32b-int8"])
def test_reduced_forward_and_decode(arch, replace):
    cfg = get_reduced(arch).replace(**replace)
    m = build_model(cfg, device="cpu")
    params = m.init_params(0)
    b, s = 2, 16
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s)))
    batch = {"tokens": tokens, "cache": m.init_cache(b, s + 4)}
    step = {}
    if cfg.family == "encdec":
        frames = torch.from_numpy(rng.standard_normal(
            (b, cfg.encoder_frames, cfg.d_model)).astype(np.float32))
        batch["frames"] = frames
        step["enc_out"] = m.encode(params, frames)
        full, none = encdec.decode(params, tokens, step["enc_out"], cfg)
    else:
        full, none = transformer.forward(params, cfg, tokens)
    assert none is None and full.shape == (b, s, cfg.vocab_size)
    assert torch.isfinite(full).all()

    logits, cache = m.prefill(params, batch)
    assert logits.shape == (b, s, cfg.vocab_size)
    assert torch.isfinite(logits).all()

    dec = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (b, 1)))
    logits2, _ = m.decode_step(params, {"tokens": dec, "cache": cache,
                                        **step})
    assert logits2.shape == (b, 1, cfg.vocab_size)
    assert torch.isfinite(logits2).all()


def test_the_port_builds_every_family_it_has_ported():
    """Every family of the reference, and every architecture: the port's
    ARCH_IDS are the reference's."""
    assert {get_reduced(a).family for a in ARCH_IDS} == {
        "dense", "moe", "ssm", "hybrid", "vlm", "encdec"}
    assert len(ARCH_IDS) == 10
