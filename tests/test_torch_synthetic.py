"""The port's numpy copy of the synthetic generators gives bitwise the
arrays of the JAX package's originals (event_flow_tpu/data/synthetic.py)
for the same seed: same draws from the generator, in the same order.
"""

import numpy as np
import pytest

from event_flow_tpu.data import synthetic as ref
from event_flow_tpu_torch.data import synthetic as ours


@pytest.mark.parametrize("seed,n_events,res,velocity,sharp_points", [
    (0, 1000, (16, 16), (1.5, 3.0), 24),
    (1, 15000, (180, 240), (2.5, 2.0), 24),
    (7, 37, (9, 13), (-3.7, 0.25), 64),
    (123, 5000, (128, 128), (0.0, -4.0), 1),
])
def test_constant_flow_window_bitwise(seed, n_events, res, velocity,
                                      sharp_points):
    a = ours.constant_flow_window(np.random.default_rng(seed), n_events, res,
                                  velocity, sharp_points=sharp_points)
    b = ref.constant_flow_window(np.random.default_rng(seed), n_events, res,
                                 velocity, sharp_points=sharp_points)
    assert a.dtype == b.dtype == np.float32
    assert a.shape == (n_events, 4)
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,batch,n_events,res,num_windows", [
    (0, 2, 100, (16, 16), 1),
    (3, 3, 257, (20, 28), 2),
    (5, 1, 1000, (128, 128), 3),
])
def test_synthetic_window_stream_bitwise(seed, batch, n_events, res,
                                         num_windows):
    gen_a = ours.synthetic_window_stream(seed, batch, n_events, res,
                                         num_windows)
    gen_b = ref.synthetic_window_stream(seed, batch, n_events, res,
                                        num_windows)
    for _ in range(3):
        a, b = next(gen_a), next(gen_b)
        assert a.shape == (batch, num_windows, n_events, 4)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
