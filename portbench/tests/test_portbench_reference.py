"""The benchmark's references against the program on the CPU at tiny sizes,
its bit rule against the program's registry, its weight generator, the
control, and the import guard."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest
import torch

from portbench import guard, inputs, program, weights
from portbench.reference import lower, resnet_v1
from portbench.tests import tiny

torch.set_num_threads(1)
SEED = 2 ** 33 + 7


def _config(name):
    with open(os.path.join(tiny.HERE, 'configs', name + '.json')) as f:
        return json.load(f)


def _images(n=4, size=32):
    return torch.from_numpy(inputs.float_images(SEED, n, size))


def test_reference_equals_program():
    """The reference's logits equal the program's CPU engine's (its
    kernels' plain versions), bit for bit."""
    tensors = weights.generate(tiny.RESNET, SEED)
    eng = program.engine(program.frozen(tiny.RESNET, tensors), 'cpu')
    x = _images()
    assert torch.equal(eng(x), resnet_v1.forward(tiny.RESNET, tensors, x))


def test_reference_equals_program_uint8():
    tensors = weights.generate(tiny.RESNET, SEED)
    eng = program.engine(program.frozen(tiny.RESNET, tensors), 'cpu',
                         input_mode='uint8')
    u8 = torch.from_numpy(inputs.uint8_images(SEED, 4, 32))
    assert torch.equal(eng(u8), resnet_v1.forward(tiny.RESNET, tensors, u8,
                                                  'uint8'))


def test_bit_rule_is_the_published_table():
    """The bits the benchmark hands the program are the program's own
    uniform8 table for the configuration, key for key."""
    config = _config('resnet50_w8a8')
    plan = weights.family_plan(config)
    keys = {f'{k}.weight_int': 0 for k, *_ in plan.convs}
    keys.update({f'{k}.act_scale': 0 for k in plan.acts})
    ours = program.bit_table(config, keys)
    published = program.published_table(config)
    assert {k: published.get(k, 8) for k in ours} == ours


def test_logits_depend_on_the_image():
    """Every image gets logits of its own: each pair of images differs in
    nearly every logit, by many steps of the logits' grid."""
    tensors = weights.generate(tiny.RESNET, SEED)
    y = resnet_v1.forward(tiny.RESNET, tensors, _images(6))
    for i in range(6):
        for j in range(i):
            assert (y[i] != y[j]).float().mean() > 0.9
    assert float(y.std(0).mean()) > 1e-3 * float(y.abs().mean())


def test_control_is_not_correct():
    """The int4 control, in the program's place, reads a logit gap far
    above the limit 0 that the program's runs are held to."""
    config = tiny.RESNET
    tensors = weights.generate(config, SEED)
    x = _images()
    c4, t4 = lower.int4(config, tensors)
    gap = float((resnet_v1.forward(c4, t4, x)
                 - resnet_v1.forward(config, tensors, x)).abs().max())
    assert gap > 0.01


def test_weights_repeat_from_the_seed():
    a = weights.generate(tiny.RESNET, SEED)
    b = weights.generate(tiny.RESNET, SEED)
    c = weights.generate(tiny.RESNET, SEED + 1)
    assert all(np.array_equal(a[k], b[k]) for k in a)
    assert not np.array_equal(a['quant_output.weight_int'],
                              c['quant_output.weight_int'])


def test_benchmark_imports_neither_jax_nor_the_jax_package():
    assert guard.source_imports() == []


def test_guard_compares_whole_top_level_names(tmp_path):
    ref = tmp_path / 'reference'
    ref.mkdir()
    (tmp_path / 'a.py').write_text('import hawq_tpu_torch.deploy\n'
                                   'import jaxtyping\n')
    (tmp_path / 'b.py').write_text('from hawq_tpu.kernels import conv\n')
    (ref / 'c.py').write_text('import hawq_tpu_torch\nimport jax.numpy\n')
    assert sorted(guard.source_imports(str(tmp_path))) == [
        ('b.py', 'hawq_tpu.kernels'), ('reference/c.py', 'hawq_tpu_torch'),
        ('reference/c.py', 'jax.numpy')]
    assert guard.top('hawq_tpu_torch.x') != 'hawq_tpu'
