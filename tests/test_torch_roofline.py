"""The port's roofline (``repro_torch.launch.roofline``) against the JAX
package's: the cases of ``test_roofline_unit.py`` that parse no HLO (the
port counts its collectives where its meshes run them), with the H100
constants, and ``model_flops`` equal to JAX's for every arch and face."""
import test_torch_threads  # noqa: F401  (first: one torch thread)
import pytest

from repro.configs import base as jbase
from repro.launch import roofline as jroof
from repro_torch.configs import base
from repro_torch.kernels import work
from repro_torch.launch import roofline

ASSIGNED = [a for a in base.ARCH_IDS if a != "bert-base-cobra"]


def test_terms_math_with_the_h100_constants():
    """One second of each term at the H100 rates: bf16 989 TFLOP/s, HBM
    3.35 TB/s, 50 GB/s a GPU on the network; the kernels' int8 and word
    operations each at their own rate, compute the largest."""
    art = {"flops": 989e12, "bytes_accessed": 3.35e12,
           "collectives": {"all-reduce": 30e9, "all-gather": 20e9}}
    cfg = base.get_config("smollm-135m")
    shape = base.SHAPES["train_4k"]
    t = roofline.terms_from_artifact(art, cfg, shape, "train")
    assert t.compute_s == pytest.approx(1.0)
    assert t.memory_s == pytest.approx(1.0)
    assert t.collective_s == pytest.approx(1.0)
    assert t.model_flops == pytest.approx(
        6.0 * cfg.active_param_count() * shape.global_batch * shape.seq_len)
    assert work.HBM_BYTES_PER_S == 3.35e12 and work.BF16_FLOPS == 989e12
    assert roofline.NET_BW == 50e9
    art = {"unit_ops": {"int8": 2 * 1979e12, "word": 67e12, "bf16": 0}}
    t = roofline.terms_from_artifact(art)
    assert t.int8_s == pytest.approx(2.0) and t.word_s == pytest.approx(1.0)
    assert t.compute_s == pytest.approx(2.0) and t.dominant == "compute"


def test_dominant_term():
    art = {"flops": 1e12, "bytes_accessed": 3.35e12 * 10,
           "collectives": {}}
    t = roofline.terms_from_artifact(art)
    assert t.dominant == "memory"
    assert t.step_time_s == pytest.approx(10.0)
    d = t.to_dict()
    assert d["dominant"] == "memory" and d["step_time_s"] == t.step_time_s


def test_40_cell_accounting_equals_jax():
    """10 assigned archs x 4 shapes = 40 cells a mesh; the port's
    ``valid_shapes`` skips the JAX package's 6."""
    assert ASSIGNED == [a for a in jbase.ARCH_IDS if a != "bert-base-cobra"]
    assert len(ASSIGNED) * len(base.SHAPES) == 40
    runnable = 0
    for a in ASSIGNED:
        got = set(base.valid_shapes(base.get_config(a)))
        assert got == set(jbase.valid_shapes(jbase.get_config(a))), a
        runnable += len(got)
    assert runnable == 34
    long_runners = {a for a in ASSIGNED
                    if "long_500k" in base.valid_shapes(base.get_config(a))}
    assert long_runners == {"mixtral-8x22b", "gemma3-27b", "hymba-1.5b",
                            "xlstm-350m"}


@pytest.mark.parametrize("arch", ASSIGNED)
def test_model_flops_equal_jax(arch):
    cfg, jcfg = base.get_config(arch), jbase.get_config(arch)
    for name, shape in base.SHAPES.items():
        face = shape.kind
        assert roofline.model_flops(cfg, shape, face) == \
            jroof.model_flops(jcfg, jbase.SHAPES[name], face), (arch, name)
