"""DPMM image-compression demo: the JAX analog of the reference's
canonical example (reference examples/mixture/main.py:28-377).

Samples 2-D points from an image's intensity distribution, fits a
Pitman-Yor x (NICH, NICH) DPMM with four inference strategies, and
re-synthesizes the image from the learned predictive density:

  sequential  — greedy posterior-predictive assignment (one pass)
  gibbs       — prior init + blocked collapsed-Gibbs passes
  seq-gibbs   — sequential init + blocked collapsed-Gibbs passes
  annealing   — subsample annealing
  smc         — SMC particle-filter init (new: no reference analog)

Unlike the reference (four OS processes, main.py:365-374), the strategies
here run sequentially by default, each as fully device-resident kernels;
`--chains N` demonstrates chain parallelism instead (vmapped Gibbs).

Usage:
  python examples/mixture/main.py run [--samples 10000] [--passes 10]
  python examples/mixture/main.py gibbs
"""

import argparse
import os
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from distributions_tpu import clustering, mixture as mx
from distributions_tpu.models import nich
from distributions_tpu.ops import gibbs as gibbs_ops
from distributions_tpu.inference import annealing as annealing_mod
from distributions_tpu.inference import smc as smc_mod
from distributions_tpu.io.stream import json_stream_dump, json_stream_load

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, 'data')
RESULTS = os.path.join(ROOT, 'results')
SAMPLES = os.path.join(DATA, 'samples.json.gz')

SAMPLE_COUNT = 10000
PASSES = 10
EMPTY_GROUP_COUNT = 10  # reference main.py:51
CAPACITY = 768
BLOCK = 500


def default_image(width=64, height=64):
    """Synthetic stand-in for the reference's fox.png (not shipped): a few
    gaussian blobs rendered to a grayscale intensity array."""
    yy, xx = np.mgrid[0:width, 0:height].astype(np.float64)
    img = np.zeros((width, height))
    rng = np.random.RandomState(0)
    for _ in range(6):
        cx, cy = rng.rand(2) * [width, height]
        sx, sy = 3 + 8 * rng.rand(2)
        img += np.exp(-((xx - cy) ** 2 / (2 * sy ** 2)
                        + (yy - cx) ** 2 / (2 * sx ** 2)))
    img = 255 * (1.0 - img / img.max())
    return img.astype(np.uint8)


def load_image():
    try:
        from PIL import Image  # optional
        path = os.path.join(ROOT, 'fox.png')
        if os.path.exists(path):
            return np.asarray(Image.open(path).convert('L'))
    except ImportError:
        pass
    return default_image()


class ImageModel(object):
    """reference main.py:59-70."""

    def __init__(self):
        self.clustering = clustering.PitmanYor.from_dict(
            {'alpha': 100.0, 'd': 0.1})
        self.feature = nich.shared_from_dict(
            {'mu': 0.0, 'kappa': 0.1, 'sigmasq': 0.01, 'nu': 1.0})
        self.spec = mx.make_spec([(nich, 2)], capacity=CAPACITY,
                                 empties=EMPTY_GROUP_COUNT)
        self.shareds = (self.feature,)


def sample_from_image(key, image, sample_count):
    """Draw (x, y) points with density inverse to pixel intensity, scaled to
    [-1, 1] (reference main.py:126-140)."""
    image = -1.0 * np.asarray(image, np.float64)
    image -= image.min()
    x_pmf = image.sum(axis=1)
    x_pmf /= x_pmf.sum()
    y_pmfs = image / (image.sum(axis=1, keepdims=True) + 1e-8)

    k1, k2 = jax.random.split(key)
    xs = np.asarray(jax.random.categorical(
        k1, jnp.log(jnp.asarray(x_pmf) + 1e-12), shape=(sample_count,)))
    ys = np.empty(sample_count, np.int64)
    ykeys = jax.random.split(k2, sample_count)
    # vectorized per-row categorical via gumbel on log pmf rows
    logits = jnp.log(jnp.asarray(y_pmfs[xs]) + 1e-12)
    ys = np.asarray(jax.random.categorical(k2, logits, axis=-1))

    x_scale = 2.0 / (image.shape[0] - 1)
    y_scale = 2.0 / (image.shape[1] - 1)
    return np.stack([xs * x_scale - 1.0, ys * y_scale - 1.0],
                    axis=1).astype(np.float32)


def synthesize_image(model, state, width, height):
    """Evaluate the mixture predictive density on the pixel grid
    (reference main.py:143-159)."""
    x_scale = 2.0 / (width - 1)
    y_scale = 2.0 / (height - 1)
    xs = jnp.arange(width) * x_scale - 1.0
    ys = jnp.arange(height) * y_scale - 1.0
    grid = jnp.stack(jnp.meshgrid(xs, ys, indexing='ij'),
                     axis=-1).reshape(-1, 2)
    scores = mx.score_batch(model.spec, model.clustering, model.shareds,
                            state, (grid,))
    probs = jnp.sum(jnp.exp(scores), axis=-1).reshape(width, height)
    image = np.asarray(probs / probs.max())
    image = ((1.0 - image) * 255).astype(np.uint8)
    return image


def save_image(image, name):
    os.makedirs(RESULTS, exist_ok=True)
    path = os.path.join(RESULTS, name)
    try:
        from PIL import Image
        Image.fromarray(image).save(path)
    except ImportError:
        np.save(path + '.npy', image)
    return path


def create_dataset(key, sample_count=SAMPLE_COUNT):
    image = load_image()
    samples = sample_from_image(key, image, sample_count)
    json_stream_dump((list(map(float, xy)) for xy in samples), SAMPLES)
    return image, samples


def load_dataset():
    data = np.asarray([xy for xy in json_stream_load(SAMPLES)],
                      np.float32)
    return data


def _pad(X, multiple):
    R = X.shape[0]
    pad = (-R) % multiple
    if pad:
        X = np.concatenate([X, X[:pad]], axis=0)
    return X


def compress_sequential(model, X, key):
    """reference main.py:191-210."""
    values = (jnp.asarray(X),)
    state = mx.init(model.spec, model.shareds)
    state, assignments = gibbs_ops.sequential_init(
        model.spec, model.clustering, model.shareds, state, values, key)
    return state, assignments


def compress_gibbs(model, X, key, passes=PASSES, init='prior'):
    """reference main.py:213-286 (prior- or sequential-init + Gibbs)."""
    X = _pad(X, BLOCK)
    values = (jnp.asarray(X),)
    state = mx.init(model.spec, model.shareds)
    key, sub = jax.random.split(key)
    if init == 'prior':
        state, assignments = gibbs_ops.prior_init(
            model.spec, model.clustering, model.shareds, state, values, sub)
    else:
        state, assignments = gibbs_ops.sequential_init(
            model.spec, model.clustering, model.shareds, state, values, sub)
    for _ in range(passes):
        key, sub = jax.random.split(key)
        state, assignments = gibbs_ops.sweep_blocked(
            model.spec, model.clustering, model.shareds, state, values,
            assignments, BLOCK, key=sub)
    return state, assignments


def compress_annealing(model, X, key, passes=PASSES):
    """reference main.py:310-344."""
    X = _pad(X, BLOCK)
    values = (jnp.asarray(X),)
    return annealing_mod.anneal(
        model.spec, model.clustering, model.shareds, values, key,
        passes=passes, tile=BLOCK)


def compress_smc(model, X, key, n_particles=8):
    """SMC particle-filter init (no reference analog)."""
    values = (jnp.asarray(X),)
    states, assignments, logw, log_ev = smc_mod.smc_init(
        model.spec, model.clustering, model.shareds, values, n_particles,
        64, key)
    state, assign = smc_mod.best_particle(states, assignments, logw)
    return state, assign


STRATEGIES = {
    'sequential': compress_sequential,
    'gibbs': compress_gibbs,
    'seq-gibbs': lambda m, X, k, **kw: compress_gibbs(
        m, X, k, init='sequential', **kw),
    'annealing': compress_annealing,
    'smc': compress_smc,
}


def run_strategy(name, model, X, key, image_shape):
    t0 = time.time()
    state, assignments = STRATEGIES[name](model, X, key)
    n_components = int((np.asarray(state.counts) > 0).sum())
    dt = time.time() - t0
    print('{} found {} components in {:.1f}s'.format(name, n_components, dt))
    img = synthesize_image(model, state, *image_shape)
    path = save_image(img, name.replace('-', '_') + '.png')
    return state, assignments


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument('command', nargs='?', default='run',
                        choices=['run'] + list(STRATEGIES))
    parser.add_argument('--samples', type=int, default=SAMPLE_COUNT)
    parser.add_argument('--passes', type=int, default=PASSES)
    parser.add_argument('--seed', type=int, default=0)
    args = parser.parse_args()
    from distributions_tpu import runtime
    runtime.enable_compile_cache()

    key = jax.random.PRNGKey(args.seed)
    key, sub = jax.random.split(key)
    image, X = create_dataset(sub, args.samples)
    save_image(image, 'original.png')
    model = ImageModel()

    names = list(STRATEGIES) if args.command == 'run' else [args.command]
    for name in names:
        key, sub = jax.random.split(key)
        run_strategy(name, model, X, sub, image.shape)


if __name__ == '__main__':
    main()
