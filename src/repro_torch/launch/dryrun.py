"""Multi-rank dry-run: run every (arch x shape x mesh) cell once on a fake
process group and price it at the H100's rates.

Port of ``repro.launch.dryrun``.  One process plays rank 0 of the whole
mesh (16 x 16, or 2 x 16 x 16 with ``--multi-pod``) on PyTorch's fake
backend (``launch.mesh.fake_group``), whose collectives move nothing.
The mesh claims the cards (``--device``, default ``cuda``); each rank's
local tensors live on the ``meta`` device, which has shapes, dtypes and
storage sizes but no storage: nothing is allocated, on the card or the
host.  The reference's 512 placeholder devices play the same part.
(``FakeTensorMode`` would let the local tensors claim the card too, but
DTensor's sharding propagation builds index tensors of its own for
strided shards and reads them back, which fails under it.)

Per cell this script:
  1. builds the parameters (and, to train, the AdamW moments) at the
     placements of ``registry.param_pspecs`` and the inputs at those of
     ``registry.input_shardings``, as ``DTensor``s on the mesh; a train
     cell installs the reference's activation sharding (batch over the DP
     axes, hidden over ``model``);
  2. runs the step once (``train.loop.make_train_step`` with the
     reference's accumulation factor, ``prefill`` or ``decode_step``):
     DTensor's sharding propagation then issues every collective, as
     GSPMD does when the reference compiles, and a failing cell is a
     sharding that does not hold;
  3. records, for rank 0, what its local tensors did (:class:`StepMeter`):
     - ``peak_bytes_per_dev``: the most bytes of live local storage
       (state, inputs, activations, gradients, collective buffers; no
       allocator rounding or workspace);
     - ``flops_per_dev``: the flops of every matmul-like op
       (``torch.utils.flop_counter``'s formulas) on local shapes, by
       dtype; elementwise ops are not counted;
     - ``bytes_per_dev``: every non-view op's input and output bytes.
       This is eager traffic without fusion, an upper bound on what a
       fused program would move;
     - the collectives by kind (``roofline.collective_bytes``);
  4. prices them with ``roofline.analyze`` at the H100's peaks.

Each cell that ran names the torch release that produced it (``torch``):
DTensor's strategies, and so the per-card numbers, change between
releases.  The reference's ``lower_s``/``compile_s`` have no counterpart:
the port reports ``build_s`` (building the cell's state and inputs) and
``run_s`` (running the step under the meter).  Its layers, flash
attention and recurrent scans are Python loops, so every trip is
counted: the reference's ``cost_extrapolation`` and loop corrections
are not needed, and each cell's ``correction`` says so beside the
reference's figure (``analysis.corrections``).

Usage:
  python -m repro_torch.launch.dryrun --arch yi_9b --shape train_4k
  python -m repro_torch.launch.dryrun --all --multi-pod --out reports/dryrun.json
  (``--device cpu`` lays the mesh over the CPU; the default, ``cuda``,
  needs a card, which the run does not touch beyond binding it.)
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
import weakref

import torch
from torch._guards import active_fake_mode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.analysis import roofline
from repro_torch.analysis.corrections import cell_correction
from repro_torch.configs import ARCHS, get_config
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import layers as L
from repro_torch.models import registry
from repro_torch.train import loop as loop_mod
from repro_torch.train import optimizer as opt_mod

# Gradient-accumulation factors for train_4k, the reference's (chosen
# there so each cell's per-device live set fits the reference's HBM).
TRAIN_ACCUM = {
    "codeqwen15_7b": 2, "yi_9b": 2, "granite_34b": 4, "command_r_35b": 4,
    "llama4_scout_17b_a16e": 8, "qwen2_moe_a27b": 8, "llava_next_34b": 8,
    "seamless_m4t_medium": 2, "xlstm_125m": 4, "recurrentgemma_2b": 16,
}
# multi-pod overrides: (global_batch / accum) must stay divisible by
# dp = pod * data = 32, so accum <= 8 at batch 256
TRAIN_ACCUM_MULTIPOD = {"recurrentgemma_2b": 8, "llama4_scout_17b_a16e": 8}

# long_500k needs sub-quadratic attention; full-attention archs skip it
CELLS_SKIP = {
    ("codeqwen15_7b", "long_500k"): "full attention (O(S^2)) — skip per assignment",
    ("yi_9b", "long_500k"): "full attention — skip",
    ("granite_34b", "long_500k"): "full attention — skip",
    ("command_r_35b", "long_500k"): "full attention — skip",
    ("llama4_scout_17b_a16e", "long_500k"): "full attention — skip",
    ("qwen2_moe_a27b", "long_500k"): "full attention — skip",
    ("llava_next_34b", "long_500k"): "full attention — skip",
    ("seamless_m4t_medium", "long_500k"): "full attention — skip",
}

CORRECTION_NOTE = ("exact: every layer, flash block and scan step runs "
                   "as Python and is counted (the reference's XLA count "
                   "adds {flops:.4g} flops globally here: {note})")


# ---------------------------------------------------------------------------
# The meter
# ---------------------------------------------------------------------------

def _storages(tree):
    out = []
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            out.append(t.untyped_storage())
    return out


class StepMeter(TorchDispatchMode):
    """What rank 0's local tensors do while active.

    A ``DTensor`` op is let through (``NotImplemented``) so the meter
    sees the local ops and collectives DTensor runs for it; counting the
    ``DTensor`` op itself would price the global shapes.  ``flops`` is
    keyed by the result's dtype; ``live``/``peak`` count each local
    storage once, from the op that made it until it is freed.  Ops that
    DTensor's sharding propagation runs on global shapes are not
    counted."""

    def __init__(self):
        super().__init__()
        self.flops: dict[str, float] = {}
        self.bytes = 0
        self.collectives: list = []
        self.live = 0
        self.peak = 0
        self._seen: dict[int, int] = {}

    def track(self, tree) -> int:
        """Count the storages of ``tree``'s tensors (local shards of
        ``DTensor``s) as live; returns the bytes newly counted."""
        added = 0
        for t in registry.tree_leaves(tree):
            if isinstance(t, torch.Tensor):
                t = t.to_local() if hasattr(t, "to_local") else t
                added += self._add(t.untyped_storage())
        return added

    def _add(self, st) -> int:
        key = id(st)
        if key in self._seen:
            return 0
        n = st.nbytes()
        self._seen[key] = n
        weakref.finalize(st, self._free, key)
        self.live += n
        self.peak = max(self.peak, self.live)
        return n

    def _free(self, key):
        self.live -= self._seen.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        # DTensor runs each new op once on global-shape stand-ins under a
        # fake mode of its own to learn the output's shape: not rank 0's
        # work.  wait_tensor returns its input in eager runs.
        if active_fake_mode() is not None \
                or func is torch.ops._c10d_functional.wait_tensor.default:
            return out
        packet = func._overloadpacket
        if packet in flop_registry:
            dt = next((str(t.dtype).replace("torch.", "")
                       for t in tree_leaves(out)
                       if isinstance(t, torch.Tensor)), "?")
            n = flop_registry[packet](*args, **kwargs, out_val=out)
            self.flops[dt] = self.flops.get(dt, 0.0) + float(n)
        if not getattr(func, "is_view", False):
            self.bytes += roofline._nbytes((args, kwargs)) \
                + roofline._nbytes(out)
        roofline.record_collective(self.collectives, func, args, kwargs,
                                   out)
        for st in _storages(out):
            self._add(st)
        return out


# ---------------------------------------------------------------------------
# Cells
# ---------------------------------------------------------------------------



def _act_placements(mesh, model_dim: int = 2):
    """The reference's residual-stream sharding: batch over the DP axes,
    hidden (``model_dim`` 2; 1 shards the sequence) over ``model``."""
    from torch.distributed.tensor import Replicate, Shard
    dpx = mesh_mod.dp_axes(mesh)
    return [Shard(0) if a in dpx else Shard(model_dim) if a == "model"
            else Replicate() for a in mesh.mesh_dim_names]


def _params(cfg, mesh, trainable: bool):
    params = L.Params(registry.family_module(cfg).param_tree(
        cfg, L.ShapeInit()))
    specs = registry.param_pspecs(cfg, params,
                                  mesh_mod.mesh_shape_dict(mesh))
    if trainable:
        params.requires_grad_(True)
    return params, specs


def _inputs(stand_ins, specs, mesh):
    """Each ``meta`` stand-in as a ``DTensor`` on ``mesh`` at its spec
    (int32 token ids as the port's int64; a cache's ``len`` as the
    Python int the port keeps)."""
    from torch.distributed.tensor import distribute_tensor
    flat = iter(registry.tree_leaves(specs))

    def one(path, leaf):
        spec = next(flat)
        if path and path[-1] == "len":
            return 0
        dtype = torch.long if leaf.dtype == torch.int32 and path[-1] in (
            "tokens", "labels", "token") else leaf.dtype
        t = torch.empty(leaf.shape, dtype=dtype, device="meta")
        return distribute_tensor(t, mesh, registry.placements(spec, mesh))
    return registry.map_tree(one, stand_ins)


def build_train_cell(cfg, sh, mesh, accum=1, remat=True, act_dim=2):
    """(run, the state and inputs it holds) for a train cell of shape
    ``sh`` (a ``registry.SHAPES`` entry); the residual stream's ``model``
    split is on dimension ``act_dim`` (``None``: no constraint)."""
    mesh_shape = mesh_mod.mesh_shape_dict(mesh)
    if act_dim is not None:
        L.set_activation_sharding(mesh, _act_placements(mesh, act_dim))
    params, specs = _params(cfg, mesh, trainable=True)
    state = {"params": params, "opt": opt_mod.init_opt_state(params),
             "step": torch.zeros((), dtype=torch.int32, device="meta")}
    state = loop_mod.shard_train_state(state, mesh, specs)
    stand_ins = registry.input_specs(cfg, sh)["batch"]
    batch = _inputs(stand_ins, registry.input_shardings(
        cfg, sh, stand_ins, mesh_mod.dp_axes(mesh), mesh_shape),
        mesh)
    step = loop_mod.make_train_step(cfg, opt_mod.OptConfig(), remat=remat,
                                    accum=accum)
    return (lambda: step(state, batch)), (state, batch)


def _infer_inputs(cfg, sh, mesh):
    mesh_shape = mesh_mod.mesh_shape_dict(mesh)
    params, p_specs = _params(cfg, mesh, trainable=False)
    params = registry.distribute_params(params, mesh, p_specs)
    stand_ins = registry.input_specs(cfg, sh)
    inputs = _inputs(stand_ins, registry.input_shardings(
        cfg, sh, stand_ins, mesh_mod.dp_axes(mesh), mesh_shape),
        mesh)
    return registry.get_model(cfg), params, inputs


def build_prefill_cell(cfg, sh, mesh):
    model, params, inputs = _infer_inputs(cfg, sh, mesh)
    extras = {k: inputs[k] for k in ("prefix_embeds", "frames")
              if k in inputs}

    def run():
        with torch.no_grad(), _implicit():
            return model.prefill(params, inputs["tokens"], cfg,
                                 inputs["cache"], **extras)
    return run, (params, inputs)


def build_decode_cell(cfg, sh, mesh):
    model, params, inputs = _infer_inputs(cfg, sh, mesh)
    cache = inputs["cache"]
    cache["len"] = sh["seq"] - 1                            # a full cache

    def run():
        with torch.no_grad(), _implicit():
            return model.decode_step(params, inputs["token"], cache, cfg)
    return run, (params, inputs)


def _implicit():
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def _mesh_key(mesh) -> str:
    return "x".join(map(str, mesh.shape))


def run_cell(arch: str, shape_name: str, mesh, *, report: dict,
             cfg=None, shape=None, accum=None) -> dict:
    """Run one cell on ``mesh`` (over a fake group of its size) and put
    its entry into ``report`` under ``arch/shape/mesh``; returns it.
    ``cfg`` replaces the arch's configuration (a cut one in tests),
    ``shape`` the shape's dict (``registry.SHAPES``'s form; the cell is
    then named ``shape_name``) and ``accum`` its accumulation factor."""
    cfg = cfg or get_config(arch)
    sh = shape or registry.SHAPES[shape_name]
    key = f"{arch}/{shape_name}/{_mesh_key(mesh)}"
    if (arch, shape_name) in CELLS_SKIP:
        report[key] = {"status": "skipped",
                       "reason": CELLS_SKIP[(arch, shape_name)]}
        print(f"[skip] {key}: {CELLS_SKIP[(arch, shape_name)]}", flush=True)
        return report[key]
    t0 = time.time()
    L.set_activation_sharding(None)
    if accum is None:
        accum = TRAIN_ACCUM.get(arch, 1)
        if "pod" in mesh.mesh_dim_names:
            accum = TRAIN_ACCUM_MULTIPOD.get(arch, accum)
    builders = {"train": lambda: build_train_cell(cfg, sh, mesh, accum),
                "prefill": lambda: build_prefill_cell(cfg, sh, mesh),
                "decode": lambda: build_decode_cell(cfg, sh, mesh)}
    try:
        run, held = builders[sh["kind"]]()
        t_build = time.time() - t0
        meter = StepMeter()
        args_bytes = meter.track(held)
        with meter:
            out = run()
        out_bytes = meter.track(out) if sh["kind"] != "train" else 0
        del out, run, held
        t_run = time.time() - t0 - t_build
        n_dev = mesh.size()
        flops = sum(meter.flops.values())
        corr = (cell_correction(cfg, shape_name) if shape is None
                else {"flops": 0.0, "bytes": 0.0, "note": "a shape of "
                      "its own: the reference has no figure"})
        mf = roofline.model_flops(cfg, sh["kind"], sh["seq"], sh["batch"])
        coll = roofline.collective_bytes(meter.collectives)
        rl = roofline.analyze({"flops": flops, "bytes accessed": meter.bytes},
                              coll, n_dev, mf)
        entry = {
            "status": "ok",
            "torch": torch.__version__,
            "kind": sh["kind"],
            "build_s": round(t_build, 1),
            "run_s": round(t_run, 1),
            "n_devices": n_dev,
            "accum": accum if sh["kind"] == "train" else 1,
            "memory": {
                "args_bytes_per_dev": args_bytes,
                "out_bytes_per_dev": out_bytes,
                "temp_bytes_per_dev": meter.peak - args_bytes,
                "peak_bytes_per_dev": meter.peak,
                "peak_gb_per_dev": round(meter.peak / 2**30, 3),
            },
            "flops_per_dev_counted": flops,
            "flops_per_dev": flops,
            "flops_by_dtype": meter.flops,
            "bytes_per_dev": meter.bytes,
            "correction": CORRECTION_NOTE.format(**corr),
            "reference_correction": corr,
            "collectives": coll,
            "coll_bytes_per_dev": coll["total_bytes"],
            "roofline": rl.as_dict(),
        }
        report[key] = entry
        print(f"[ok]   {key}: run={t_run:.1f}s "
              f"peak={entry['memory']['peak_gb_per_dev']}GB/dev "
              f"bottleneck={rl.bottleneck} "
              f"(tc={rl.t_compute:.3e} tm={rl.t_memory:.3e} "
              f"tx={rl.t_collective:.3e}s)", flush=True)
    except Exception as e:  # noqa: BLE001 — a failing cell is a bug report
        report[key] = {"status": "error", "error": f"{type(e).__name__}: {e}",
                       "trace": traceback.format_exc()[-2000:],
                       "torch": torch.__version__}
        print(f"[FAIL] {key}: {type(e).__name__}: {e}", flush=True)
    finally:
        L.set_activation_sharding(None)
    return report[key]


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="also run the 2x16x16 multi-pod mesh")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--out", default="reports/dryrun.json")
    ap.add_argument("--device", default="cuda",
                    help="the mesh's device type (cuda or cpu)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    archs = ARCHS if (args.all or not args.arch) else [args.arch]
    shapes = list(registry.SHAPES) if (args.all or not args.shape) \
        else [args.shape]
    pods = []
    if not args.multi_pod_only:
        pods.append(False)
    if args.multi_pod or args.multi_pod_only:
        pods.append(True)

    report: dict = {}
    for multi_pod in pods:
        with mesh_mod.fake_group(512 if multi_pod else 256):
            mesh = mesh_mod.make_production_mesh(multi_pod=multi_pod,
                                                 device=args.device)
            for arch in archs:
                for shape_name in shapes:
                    run_cell(arch, shape_name, mesh, report=report)

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    n_ok = sum(1 for v in report.values() if v["status"] == "ok")
    n_skip = sum(1 for v in report.values() if v["status"] == "skipped")
    n_err = sum(1 for v in report.values() if v["status"] == "error")
    print(f"\n== dry-run: {n_ok} ok, {n_skip} skipped, {n_err} failed "
          f"-> {args.out}", flush=True)
    return 1 if n_err else 0


if __name__ == "__main__":
    raise SystemExit(main())
