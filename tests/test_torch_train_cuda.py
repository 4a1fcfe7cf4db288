"""The training stack on the card against itself on the CPU (``cuda``
marker; skips without a card).  No JAX here: the CPU path is held to the
JAX package in ``test_torch_train.py``.

  * A reduced TinyLlama ``Trainer`` step on ``cuda`` against the same step
    on the CPU from the same state and batch (f32, TF32 off): loss rel
    1e-5, grad norm rel 1e-4, the first moments (0.1 x the clipped
    grads) allclose, and the parameters within 1e-3 of lr where the
    grad is away from 0 (above 1e-3 of its leaf's largest), within one
    step (2 lr) everywhere: Adam's first step moves a parameter by
    g / (|g| + eps) · lr, so a grad that is 0 up to its rounding may
    move it anywhere in ±lr.
  * A checkpoint round trip of CUDA bf16 and f32 tensors: the leaves come
    back on the host with their dtypes and bits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro_torch.models as tm  # noqa: E402
from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_reduced  # noqa: E402
from repro_torch.optim import AdamWState  # noqa: E402
from repro_torch.train import Trainer, TrainerConfig  # noqa: E402

LR = 3e-4


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("grad_accum", [1, 2])
def test_trainer_step_on_cuda_matches_the_cpu(tmp_path, grad_accum):
    dev = _cuda()
    cfg = get_reduced("tinyllama-1.1b", dtype="float32")
    tcfg = TrainerConfig(lr=LR, warmup_steps=0, micro_batch=2, grad_accum=grad_accum, seq_len=64,
                         ckpt_dir=str(tmp_path))
    cpu, gpu = Trainer(cfg, tcfg, device="cpu"), Trainer(cfg, tcfg, device=dev)
    params = tm.init_params(0, cfg, device="cpu")
    s_cpu = cpu.state_from_params(params)
    s_gpu = gpu.state_from_params(tm.params_from_numpy(tm.params_to_numpy(params), cfg, dev))
    s_cpu, m_cpu = cpu.step(s_cpu, cpu.batch_at(0))
    s_gpu, m_gpu = gpu.step(s_gpu, gpu.batch_at(0))
    assert float(m_gpu["loss"]) == pytest.approx(float(m_cpu["loss"]), rel=1e-5)
    assert float(m_gpu["grad_norm"]) == pytest.approx(float(m_cpu["grad_norm"]), rel=1e-4)
    assert float(m_gpu["lr"]) == float(m_cpu["lr"]) == pytest.approx(LR)
    for name, m in s_gpu["opt"].m.items():
        np.testing.assert_allclose(m.cpu().numpy(), s_cpu["opt"].m[name].numpy(), rtol=1e-4,
                                   atol=1e-4 * float(s_cpu["opt"].m[name].abs().max()), err_msg=name)
    for (name, a), (_, b) in zip(s_gpu["params"].named_parameters(), s_cpu["params"].named_parameters()):
        assert a.device.type == "cuda"
        diff = (a.detach().cpu() - b.detach()).abs()
        m = s_cpu["opt"].m[name].abs()
        away = m > 1e-3 * m.max()
        assert float(diff.max()) <= 2 * LR * (1 + 1e-3), name
        assert not away.any() or float(diff[away].max()) <= 1e-3 * LR, name
    assert int(s_gpu["opt"].step) == int(s_cpu["opt"].step) == 1


@pytest.mark.cuda
def test_checkpoint_round_trip_of_cuda_tensors(tmp_path):
    dev = _cuda()
    gen = torch.Generator(device=dev).manual_seed(0)
    tree = {
        "w": torch.randn((64, 48), generator=gen, device=dev).to(torch.bfloat16),
        "m": {"a": torch.randn((7, 5), generator=gen, device=dev)},
        "opt": AdamWState(step=torch.tensor(3, dtype=torch.int32, device=dev),
                          m={"x": torch.randn(9, generator=gen, device=dev)},
                          v={"x": torch.rand(9, generator=gen, device=dev)}),
    }
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(5, tree)
    example = {"w": 0, "m": {"a": 0}, "opt": AdamWState(step=0, m={"x": 0}, v={"x": 0})}
    step, out = mgr.restore(example=example)
    assert step == 5 and isinstance(out["opt"], AdamWState)
    pairs = [(out["w"], tree["w"]), (out["m"]["a"], tree["m"]["a"]), (out["opt"].step, tree["opt"].step),
             (out["opt"].m["x"], tree["opt"].m["x"]), (out["opt"].v["x"], tree["opt"].v["x"])]
    for got, want in pairs:
        assert got.device.type == "cpu" and got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want.cpu())
