"""Shared by ``test_torch_families.py`` (serving) and
``test_torch_families_train.py`` (training): the reduced configs of the
other LM families in both packages, their numpy-seeded inputs, and the
reference's runs, each one jitted program computed once per process.

Sequences are 48 long (the VLM: 40 tokens after 8 patches) with
``q_chunk = kv_chunk = 16``, so the kernel path really chunks, and
``ssm_chunk = 20``, so the SSD scan pads a tail.  The reference runs
``flash_jnp`` (its Pallas path cannot run on this jax); the port runs
``flash_pallas``, the CUDA kernel's plain version on CPU tensors.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

import repro.configs as RC
import repro_torch.configs as TC
from repro.launch import train as RLT
from repro.models import transformer as RT
from repro.models.params import tree_init
from repro.train import data as RD
from repro.train import train_step as RTS
from repro_torch.models import transformer as TT
from repro_torch.models.params import params_from_jax

FAMILIES = ["mamba2-130m", "zamba2-2.7b", "granite-moe-3b-a800m",
            "qwen3-moe-235b-a22b", "hubert-xlarge", "internvl2-1b"]
DECODERS = [n for n in FAMILIES if n != "hubert-xlarge"]
SEQ, NEW, BATCH = 48, 3, 2
KW = dict(q_chunk=16, kv_chunk=16, ssm_chunk=20, loss_chunk=32)
F32, GRAD = 2e-5, 1e-4


def cfgs(name, extra=(), dtype="float32"):
    """The reference's and the port's reduced config of ``name``, with
    the chunks above and ``extra`` field overrides."""
    kw = dict(KW, **dict(extra))
    r = dataclasses.replace(RC.get_config(name).reduced(),
                            attention_impl="flash_jnp", **kw)
    t = dataclasses.replace(TC.get_config(name).reduced(),
                            attention_impl="flash_pallas", **kw)
    if dtype != "float32":
        r = dataclasses.replace(r, activ_dtype=jnp.bfloat16,
                                param_dtype=jnp.bfloat16)
        t = dataclasses.replace(t, activ_dtype=torch.bfloat16,
                                param_dtype=torch.bfloat16)
    return r, t


def np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(
        a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a), tree)


def to_torch(batch):
    return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


def prompt_for(cfg):
    """Numpy-seeded prompt inputs: frames and a mask for the encoder,
    tokens (and patches for the VLM) otherwise."""
    rng = np.random.default_rng(5)
    if cfg.family == "encoder":
        return {"frames": rng.standard_normal((BATCH, SEQ, cfg.d_model),
                                              dtype=np.float32),
                "mask": rng.random((BATCH, SEQ)) < 0.3}
    s = SEQ - (cfg.vlm_patches if cfg.family == "vlm" else 0)
    out = {"tokens": rng.integers(0, cfg.vocab, (BATCH, s), np.int32)}
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (BATCH, cfg.vlm_patches, cfg.vlm_patch_dim), dtype=np.float32)
    return out


CACHE_LEN = SEQ + NEW + 8


def _params(rcfg, key):
    return tree_init(RT.param_defs(rcfg), key, rcfg.param_dtype)


@functools.lru_cache(maxsize=None)
def serve_reference(name, extra=(), dtype="float32"):
    """The reference's weights and prefill (logits, cache); for a family
    as ``reduced()`` gives it, in float32, also two decode steps and the
    greedy tokens."""
    rcfg, _ = cfgs(name, extra, dtype)
    steps = NEW - 1 if not extra and dtype == "float32" \
        and rcfg.family != "encoder" else 0

    def run(key, prompt):
        params = _params(rcfg, key)
        logits, cache = RT.prefill(rcfg, params, prompt, CACHE_LEN)
        out = dict(params=params, logits=logits, cache=cache, steps=[])
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)
        toks = [tok]
        for i in range(steps):
            lg, cache = RT.decode_step(rcfg, params, cache, tok[:, None],
                                       jnp.int32(SEQ + i))
            out["steps"].append((lg, cache))
            tok = jnp.argmax(lg[:, -1], axis=-1).astype(jnp.int32)
            toks.append(tok)
        out["greedy"] = jnp.stack(toks, axis=1)
        return out

    prompt = prompt_for(rcfg)
    out = jax.jit(run)(jax.random.PRNGKey(3),
                       {k: jnp.asarray(v) for k, v in prompt.items()})
    return dict(np_tree(out), prompt=prompt,
                params=jax.tree.map(np.asarray, out["params"]))


@functools.lru_cache(maxsize=None)
def train_reference(name):
    """The reference's weights, its ``batch_for_step`` batch, and the
    loss and gradients there."""
    rcfg, _ = cfgs(name)
    shapes = RLT.reduced_shapes(rcfg, BATCH, SEQ if rcfg.family != "vlm"
                                else SEQ - rcfg.vlm_patches)
    batch = RD.batch_for_step(rcfg, "train_4k", 2, 1, shapes)

    def run(key, batch):
        params = _params(rcfg, key)
        loss, grads = jax.value_and_grad(functools.partial(
            RTS.loss_fn, rcfg))(params, batch)
        return params, loss, grads

    params, loss, grads = jax.jit(run)(jax.random.PRNGKey(3), batch)
    return dict(params=jax.tree.map(np.asarray, params),
                batch=jax.tree.map(np.asarray, batch), loss=float(loss),
                grads=jax.tree.map(np.asarray, grads))


def port(name, ref, extra=(), dtype="float32", **kw):
    """The port's config (``kw`` overrides) and model loaded with the
    reference run's weights."""
    _, tcfg = cfgs(name, extra, dtype)
    tcfg = dataclasses.replace(tcfg, **kw)
    model = TT.build_model(tcfg, "cpu")
    model.load_state_dict(params_from_jax(ref["params"]))   # strict
    return tcfg, model
