"""hawq_tpu_torch DynamicBatcher on the CPU: every request's answer equals
the matching row of one batched engine call (and the JAX engine's logits)."""

import numpy as np
import jax.numpy as jnp
import torch

from hawq_tpu.configs.bit_config import get_bit_config
from hawq_tpu.inference.engine import build_resnet_engine as jax_engine
from hawq_tpu.inference.synthetic import synthetic_frozen_resnet

from hawq_tpu_torch.inference.engine import build_resnet_engine
from hawq_tpu_torch.inference.fold import fold4_images
from hawq_tpu_torch.inference.freeze import frozen_from_numpy
from hawq_tpu_torch.parallel.serving import DynamicBatcher

torch.set_num_threads(1)


def test_batcher_rows_equal_batched_call():
    jfm = synthetic_frozen_resnet('tiny50', get_bit_config('tiny50', 'uniform8'),
                                  num_classes=10, seed=4)
    fm = frozen_from_numpy(jfm.arch, jfm.cfg.name, dict(jfm.cfg.table),
                           jfm.tensors, jfm.num_classes)
    engine = build_resnet_engine(fm, input_mode='folded_float32',
                                 residual_dtype=torch.int16, device='cpu')
    batch = 4
    imgs = np.random.RandomState(5).randn(10, 32, 32, 3).astype(np.float32)

    batcher = DynamicBatcher(engine, batch, (32, 32, 3), max_delay_ms=20,
                             host_transform=fold4_images, device='cpu')
    try:
        slots = [batcher.submit(im) for im in imgs]
        answers = np.stack([s.get(timeout=60) for s in slots])
    finally:
        batcher.close()
    assert not batcher._collector.is_alive()
    assert not batcher._completer.is_alive()

    padded = np.concatenate([imgs, np.zeros((2, 32, 32, 3), np.float32)])
    want = np.concatenate([engine(fold4_images(padded[i:i + batch])).numpy()
                           for i in range(0, 12, batch)])[:10]
    np.testing.assert_array_equal(answers, want)
    ref = np.asarray(jax_engine(jfm, input_mode='folded_float32',
                                residual_dtype=jnp.int16)(
        jnp.asarray(fold4_images(padded[:batch]))))
    np.testing.assert_array_equal(answers[:batch], ref)
