"""Shared set-up of the port's tests (``tests/test_torch_*.py``).

The fake process group behind a monitored mesh is process-global: it is
made once per test process (each xdist worker is one) by :func:`mesh_4x2`
and reused, never torn down.  :func:`ref_serve_cell` and
:func:`ref_train_cell` build the reference's sweep cells for any config,
the captures the port's are held against.
"""
import functools


@functools.lru_cache(maxsize=None)
def mesh_4x2():
    """A ``(data 4, model 2)`` ``DeviceMesh`` on CPU over the fake process
    group of 8 ranks."""
    from repro_torch.launch.mesh import make_test_mesh

    return make_test_mesh()


def ref_serve_cell(cfg, max_len: int = 48):
    """The reference's ``serve`` sweep cell (its ``sweep._build_serve``) for
    any ``cfg``: batch 8, prompt 32, a cache of ``max_len`` (48 in the
    sweep), stub bf16 embeddings where the config reads them.  Returns the
    cell's ``build(mesh)``."""
    import jax
    import jax.numpy as jnp
    from repro.models import build_model
    from repro.parallel import Sharder
    from repro.serve import ServeConfig, cache_shardings

    def build(mesh):
        model, shd = build_model(cfg), Sharder(mesh)
        cache_sh = cache_shardings(
            model, ServeConfig(max_len=max_len, batch=8), shd)

        def inputs(s):
            if cfg.input_mode == "embeddings":
                return {"embeds": jax.ShapeDtypeStruct(
                    (8, s, cfg.d_model), jnp.bfloat16)}
            return {"tokens": jax.ShapeDtypeStruct((8, s), jnp.int32)}

        return {"captures": [
            {"phase": "prefill", "name": "prefill",
             "fn": lambda p, b: model.prefill(p, b, shd, max_len=max_len),
             "args": (model.shapes(), inputs(32)),
             "kwargs": {"out_shardings": (None, cache_sh)}},
            {"phase": "decode", "name": "decode",
             "fn": lambda p, c, b: model.decode_step(p, c, b, shd),
             "args": (model.shapes(), model.cache_shapes(8, max_len),
                      inputs(1)),
             "kwargs": {"in_shardings": (None, cache_sh, None),
                        "out_shardings": (None, cache_sh)}}]}
    return build


def ref_train_cell(cfg):
    """The reference's train-step sweep cell (as its sweep's per-arch
    cells) for any ``cfg``: global batch 8, sequence 64.  Returns the
    cell's ``build(mesh)``."""
    from repro import configs
    from repro.models import build_model
    from repro.models.common import ShapeConfig
    from repro.optim import OptConfig
    from repro.parallel import Sharder
    from repro.train import TrainConfig
    from repro.train.train import (batch_shardings, make_train_step,
                                   train_state_shapes, train_state_shardings)

    def build(mesh):
        model, shd = build_model(cfg), Sharder(mesh)
        ocfg = OptConfig(name=cfg.optimizer, state_dtype=cfg.opt_state_dtype)
        batch = configs.input_specs(
            cfg, ShapeConfig("sweep_small", 64, 8, "train"))
        return {"fn": make_train_step(model, ocfg, TrainConfig(), shd),
                "args": (train_state_shapes(model, ocfg), batch),
                "kwargs": {"in_shardings": (
                    train_state_shardings(model, ocfg, shd),
                    batch_shardings(batch, shd))}}
    return build
