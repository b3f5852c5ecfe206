"""The reference's side of the port's sharding tests that needs a mesh of
several JAX devices: run as a script in a subprocess with 8 host CPU
devices (``--xla_force_host_platform_device_count``) and Auto mesh axes
(JAX 0.9's ``jax.make_mesh`` defaults to Explicit axes, under which the
reference's ``build_cell`` fails at the embedding gather: ROADMAP C7).

    python tests/torch_ref_mesh.py JOB.json OUT.json [ARRAYS.npz]

JOB is a list of tasks:
    {"task": "cells", "cells": [[arch, shape, variant], ...],
     "mesh": [2, 4], "remat": "none"}
        the reference's ``launch.dryrun.build_cell`` lowered and compiled
        on a ("data", "model") mesh (default (2, 4)), with
        ``RuntimeOptions(remat=...)`` (default "none"): XLA's argument and
        temp bytes and ``core.hlo_analysis``'s costs (with its dot FLOPs
        apart).
    {"task": "rows", "mesh": [2, 2, 2], "names": [...], "shape": [...],
     "spec": [...]}
        which slice of a global array each device holds under
        ``NamedSharding(mesh, P(*spec))``, by mesh coordinate.
    {"task": "seq_shard", "n": N, "scale": s, "softcap": c, "window": w,
     "pos": p}
        ``models.seq_shard_attn.decode_attn_seq_sharded`` on a (1, N) mesh
        over the arrays q, k, v, ck, cv of ARRAYS.
    {"task": "moe", "arch": a, "n": N, "capacity_factor": f}
        ``models.moe.moe_ffn(impl="shard_map")`` of reduced ``a`` (d_model
        64, vocab 128) on a (1, N) mesh, weights from ``init_moe`` at key
        0, x from ARRAYS.
Arrays a task returns go to OUT.npz beside OUT.json.
"""
import json
import os
import re
import sys
import time

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AxisType, NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402


def _mesh(shape, names):
    return jax.make_mesh(tuple(shape), tuple(names),
                         axis_types=(AxisType.Auto,) * len(shape))


def dot_flops(text: str) -> float:
    """``hlo_analysis.analyze``'s FLOPs without its elementwise term (it
    adds each fusion's output BYTES as FLOPs): the dot products only,
    trip-count aware, as the port's extractor counts matrix products."""
    from repro.core import hlo_analysis as ha
    comps, entry = ha.parse_hlo(text)
    memo = {}

    def visit(name):
        if name in memo:
            return memo[name]
        memo[name] = 0.0
        comp = comps.get(name)
        if comp is None:
            return 0.0
        f = 0.0
        for ins in comp.instrs:
            if ins.op == "dot":
                f += ha._dot_flops(ins, comp)
            elif ins.op == "fusion":
                fm = re.search(r"calls=%?([\w.\-]+)", ins.attrs)
                if fm and fm.group(1) in comps:
                    sub = comps[fm.group(1)]
                    f += sum(ha._dot_flops(i, sub) for i in sub.instrs
                             if i.op == "dot")
            elif ins.op == "while":
                bm = re.search(r"body=%?([\w.\-]+)", ins.attrs)
                cm = re.search(r"condition=%?([\w.\-]+)", ins.attrs)
                tm = ha._TRIP_RE.search(ins.attrs)
                trip = (int(tm.group(1)) if tm else
                        ha._trip_count(comps[cm.group(1)])
                        if cm and cm.group(1) in comps else 1)
                if bm:
                    f += visit(bm.group(1)) * trip
            elif ins.op in ("call", "conditional", "async-start"):
                for m in re.finditer(
                        r"(?:to_apply|called_computations?|"
                        r"branch_computations)=\{?%?([\w.\-]+)", ins.attrs):
                    f += visit(m.group(1))
        memo[name] = f
        return f
    return visit(entry)


def cells(task, arrays):
    from repro.core import hlo_analysis
    from repro.launch.dryrun import build_cell
    from repro.models import RuntimeOptions
    mesh = _mesh(task.get("mesh", (2, 4)), ("data", "model"))
    opts = RuntimeOptions(remat=task.get("remat", "none"))
    out = []
    for arch, shape, variant in task["cells"]:
        t0 = time.time()
        with mesh:
            fn, args = build_cell(arch, shape, mesh, variant=variant,
                                  opts=opts)
            compiled = fn.lower(*args).compile()
        mem = compiled.memory_analysis()
        text = compiled.as_text()
        costs = hlo_analysis.analyze(text)
        out.append({"cell": [arch, shape, variant],
                    "compile_s": time.time() - t0,
                    "argument_bytes": mem.argument_size_in_bytes,
                    "temp_bytes": mem.temp_size_in_bytes,
                    "flops": costs.flops, "dot_flops": dot_flops(text),
                    "collective_bytes": costs.collective_bytes})
    return out


def rows(task, arrays):
    mesh = _mesh(task["mesh"], task["names"])
    spec = [tuple(s) if isinstance(s, list) else s for s in task["spec"]]
    sh = NamedSharding(mesh, P(*spec))
    idx = sh.devices_indices_map(tuple(task["shape"]))
    out = []
    for coord in np.ndindex(*task["mesh"]):
        dev = mesh.devices[coord]
        sl = idx[dev]
        out.append({"coord": list(coord),
                    "slices": [[s.start or 0, task["shape"][i]
                                if s.stop is None else s.stop]
                               for i, s in enumerate(sl)]})
    return {"rows": out,
            "shard_shape": list(sh.shard_shape(tuple(task["shape"])))}


def seq_shard(task, arrays):
    from repro.models.seq_shard_attn import decode_attn_seq_sharded
    mesh = _mesh((1, task["n"]), ("data", "model"))
    a = {k: jnp.asarray(arrays[k]) for k in ("q", "k", "v", "ck", "cv")}
    with mesh:
        out, ck, cv = jax.jit(
            lambda q, k, v, ck, cv: decode_attn_seq_sharded(
                q, k, v, ck, cv, jnp.int32(task["pos"]), mesh,
                scale=task["scale"], softcap=task["softcap"],
                window=task["window"]))(a["q"], a["k"], a["v"], a["ck"],
                                        a["cv"])
    return {"arrays": {"out": np.asarray(out), "ck": np.asarray(ck),
                       "cv": np.asarray(cv)}}


def moe(task, arrays):
    from repro.configs import get_config
    from repro.configs.reduce import reduced
    from repro.models import moe as jmoe
    cfg = reduced(get_config(task["arch"]), d_model=64, vocab=128)
    p = jmoe.init_moe(jax.random.PRNGKey(0), cfg, jnp.float32)
    mesh = _mesh((1, task["n"]), ("data", "model"))
    with mesh:
        y, aux = jax.jit(lambda x: jmoe.moe_ffn(
            p, x, cfg, impl="shard_map",
            capacity_factor=task["capacity_factor"],
            shard_map_mesh=mesh))(jnp.asarray(arrays["x"]))
    return {"arrays": {"y": np.asarray(y),
                       "aux": np.asarray([aux["load_balance"],
                                          aux["router_z"]])}}


TASKS = {"cells": cells, "rows": rows, "seq_shard": seq_shard, "moe": moe}


def main():
    job = json.load(open(sys.argv[1]))
    arrays = dict(np.load(sys.argv[3])) if len(sys.argv) > 3 else {}
    results, out_arrays = [], {}
    for i, task in enumerate(job):
        r = TASKS[task["task"]](task, arrays)
        if isinstance(r, dict) and "arrays" in r:
            for k, v in r.pop("arrays").items():
                out_arrays[f"{i}.{k}"] = v
        results.append(r)
    json.dump(results, open(sys.argv[2], "w"))
    if out_arrays:
        np.savez(sys.argv[2] + ".npz", **out_arrays)


if __name__ == "__main__":
    main()
