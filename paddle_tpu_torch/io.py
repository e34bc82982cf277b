"""Model persistence: save/load vars, params, persistables, inference model.

Counterpart of ``paddle_tpu/io.py`` (python/paddle/fluid/io.py parity),
with the same files on disk, so a model saved by either package loads
into the other: one ``<var>.npy`` per variable (or one ``.npz`` bundle),
the inference program as PTPB bytes in ``__model__``
(``core/program_bin.py``) with its feed and fetch names in
``__meta__.json``, and numbered checkpoint directories with a
``__manifest__.json`` written last.

Saving copies each tensor to the host (``.detach().cpu()``). Loading puts
each value on the executor's device once, as a tensor of the dtype the
program declares for it: the JAX package stores int64 state narrowed to
int32, and the port keeps int64 (ROADMAP C), so the load casts.
"""

import json
import logging
import os
import pickle
import shutil

import numpy as np
import torch

from paddle_tpu_torch import framework
from paddle_tpu_torch.core.program_bin import (
    MAGIC,
    deserialize_program,
    serialize_program,
)
from paddle_tpu_torch.core.types import device_dtype
from paddle_tpu_torch.framework import Parameter, Variable

__all__ = [
    "save_vars",
    "save_params",
    "save_persistables",
    "load_vars",
    "load_params",
    "load_persistables",
    "prune_program",
    "save_inference_model",
    "load_inference_model",
    "get_inference_program",
    "get_parameter_value",
    "get_parameter_value_by_name",
    "save_checkpoint",
    "load_checkpoint",
]

_CKPT_MANIFEST = "__manifest__.json"
_SHARDING = "__sharding__.json"
_warned_incomplete = set()  # marker-less dirs already warned about


def is_persistable(var):
    return var.persistable


def is_parameter(var):
    return isinstance(var, Parameter)


def _scope_of(scope):
    from paddle_tpu_torch.executor import global_scope

    return scope or global_scope()


def _host_array(val):
    """A host numpy array holding ``val``'s values (a copy for a tensor
    on the card)."""
    if isinstance(val, torch.Tensor):
        return val.detach().cpu().numpy()
    return np.asarray(val)


def _file_name(name):
    return name.replace("/", "__")


def _set_loaded(scope, var, arr, device):
    """``arr`` into the scope as a tensor of ``var``'s declared dtype on
    ``device``. The tensor owns a copy: a run that writes the scope value
    in place never writes into an array the caller holds."""
    t = torch.tensor(np.asarray(arr))
    if var.dtype:
        t = t.to(device_dtype(var.dtype))
    scope.set_value(var.name, t.to(device))


def save_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None, scope=None):
    main_program = main_program or framework.default_main_program()
    if vars is None:
        vars = [v for v in main_program.list_vars() if predicate(v)]
    scope = _scope_of(scope)
    os.makedirs(dirname, exist_ok=True)
    values = [(v.name, scope.get_value(v.name)) for v in vars]
    values = [(n, _host_array(val)) for n, val in values if val is not None]
    if filename is not None:
        np.savez(os.path.join(dirname, filename), **dict(values))
        return
    for name, arr in values:
        np.save(os.path.join(dirname, _file_name(name)), arr)


def save_params(executor, dirname, main_program=None, filename=None,
                scope=None):
    return save_vars(executor, dirname, main_program,
                     predicate=is_parameter, filename=filename, scope=scope)


def save_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None):
    return save_vars(executor, dirname, main_program,
                     predicate=is_persistable, filename=filename,
                     scope=scope)


def load_vars(executor, dirname, main_program=None, vars=None,
              predicate=None, filename=None, scope=None):
    main_program = main_program or framework.default_main_program()
    if vars is None:
        vars = [v for v in main_program.list_vars() if predicate(v)]
    scope = _scope_of(scope)
    if filename is not None:
        bundle = np.load(os.path.join(dirname, filename), allow_pickle=False)
        for v in vars:
            if v.name in bundle:
                _set_loaded(scope, v, bundle[v.name], executor.device)
        return
    for v in vars:
        path = os.path.join(dirname, _file_name(v.name) + ".npy")
        if os.path.exists(path):
            _set_loaded(scope, v, np.load(path), executor.device)


def load_params(executor, dirname, main_program=None, filename=None,
                scope=None):
    return load_vars(executor, dirname, main_program,
                     predicate=is_parameter, filename=filename, scope=scope)


def load_persistables(executor, dirname, main_program=None, filename=None,
                      scope=None):
    return load_vars(executor, dirname, main_program,
                     predicate=is_persistable, filename=filename,
                     scope=scope)


def prune_program(program, feed_names, fetch_names):
    """Backward slice from the fetches (framework/prune.cc capability).

    ``feed_names`` is validated, not used for slicing: every data var
    the slice still reads must be in it, so a caller naming too few
    feeds finds out here instead of at run time."""
    pruned = program.clone()
    block = pruned.global_block()
    needed = set(fetch_names)
    keep = []
    for op in reversed(block.ops):
        if set(op.output_arg_names()) & needed:
            keep.append(op)
            needed.update(op.input_arg_names())
    keep.reverse()
    produced = set()
    for op in keep:
        produced.update(op.output_arg_names())
    missing = []
    for n in needed - produced - set(fetch_names):
        v = block._find_var_recursive(n)
        if v is not None and getattr(v, "is_data", False) \
                and not getattr(v, "persistable", False) \
                and n not in feed_names:
            missing.append(n)
    if missing:
        raise ValueError(
            "prune_program: the slice to %s still reads data vars %s "
            "not listed in feed_names %s"
            % (sorted(fetch_names), sorted(missing), sorted(feed_names)))
    block.ops = keep
    return pruned


def _names(target_vars):
    return [v.name if isinstance(v, Variable) else str(v)
            for v in target_vars]


def save_inference_model(dirname, feeded_var_names, target_vars, executor,
                         main_program=None, model_filename=None,
                         params_filename=None, scope=None):
    """Prune to the inference slice, then write the program (PTPB
    ``__model__``), its feed and fetch names (``__meta__.json``) and its
    persistables (io.py:544 parity). Returns the fetch names."""
    main_program = main_program or framework.default_main_program()
    target_names = _names(target_vars)
    inference_program = prune_program(main_program.clone(for_test=True),
                                      feeded_var_names, target_names)
    os.makedirs(dirname, exist_ok=True)
    with open(os.path.join(dirname, model_filename or "__model__"),
              "wb") as f:
        f.write(serialize_program(inference_program))
    with open(os.path.join(dirname, "__meta__.json"), "w") as f:
        json.dump({"feed_names": list(feeded_var_names),
                   "fetch_names": target_names}, f)
    save_persistables(executor, dirname, inference_program,
                      filename=params_filename, scope=scope)
    return target_names


def load_inference_model(dirname, executor, model_filename=None,
                         params_filename=None, scope=None):
    """(program, feed names, fetch vars) of a saved inference model, its
    persistables loaded into ``scope`` on the executor's device. Reads
    the PTPB ``__model__`` of either package, or the legacy pickle of a
    ``{"program", "feed_names", "fetch_names"}`` dict."""
    with open(os.path.join(dirname, model_filename or "__model__"),
              "rb") as f:
        blob = f.read()
    if blob[:4] == MAGIC:
        program = deserialize_program(blob)
        with open(os.path.join(dirname, "__meta__.json")) as f:
            meta = json.load(f)
    else:
        meta = pickle.loads(blob)
        program = meta["program"]
    load_persistables(executor, dirname, program, filename=params_filename,
                      scope=scope)
    fetch_vars = [program.global_block()._find_var_recursive(n)
                  for n in meta["fetch_names"]]
    return program, meta["feed_names"], fetch_vars


def get_inference_program(target_vars, main_program=None):
    main_program = main_program or framework.default_main_program()
    program = main_program.clone(for_test=True)
    data_names = [v.name for v in program.list_vars()
                  if getattr(v, "is_data", False)]
    return prune_program(program, data_names, _names(target_vars))


def get_parameter_value(para, executor, scope=None):
    """The current value of a Parameter as a host numpy array (io.py:818
    parity; the value lives in the scope, not the graph)."""
    if not is_parameter(para):
        raise AssertionError("%r is not a Parameter"
                             % getattr(para, "name", para))
    val = _scope_of(scope).get_value(para.name)
    if val is None:
        raise RuntimeError(
            "parameter %s has no value in scope (run the startup program "
            "first)" % para.name)
    return np.array(_host_array(val))


def get_parameter_value_by_name(name, executor, program=None, scope=None):
    """io.py:848 parity: look the Parameter up by name first."""
    program = program or framework.default_main_program()
    return get_parameter_value(program.global_block().var(name), executor,
                               scope=scope)


def _checkpoint_complete(step_dir):
    """A serial counts only when its writer got to the end: the
    ``__manifest__.json`` written last (or the ``__sharding__.json`` a
    legacy sharded save of the JAX package wrote last)."""
    return (os.path.exists(os.path.join(step_dir, _CKPT_MANIFEST))
            or os.path.exists(os.path.join(step_dir, _SHARDING)))


def _checkpoint_serials(checkpoint_dir):
    """Sorted numeric serials of the complete checkpoints; temp dirs,
    quarantined dirs and non-numeric suffixes are ignored, and a serial
    without a completion marker is skipped with a warning."""
    out = []
    for d in os.listdir(checkpoint_dir):
        suffix = d[len("checkpoint_"):]
        if not d.startswith("checkpoint_") or not suffix.isdigit():
            continue
        path = os.path.join(checkpoint_dir, d)
        if not _checkpoint_complete(path):
            if path not in _warned_incomplete:
                _warned_incomplete.add(path)
                logging.getLogger("paddle_tpu_torch.io").warning(
                    "checkpoint dir %s has no completion marker "
                    "(__manifest__.json/__sharding__.json) and is skipped; "
                    "if it is a complete legacy save, load it explicitly "
                    "with load_persistables", path)
            continue
        out.append(int(suffix))
    return sorted(out)


def save_checkpoint(executor, checkpoint_dir, main_program=None, scope=None,
                    serial=0, max_num_checkpoints=3):
    """``checkpoint_dir/checkpoint_<serial>/`` with every persistable as
    ``.npy`` (io.py:627 parity, unsharded: the sharded form is ROADMAP
    A10's), keeping the newest ``max_num_checkpoints`` serials.

    The vars land in ``checkpoint_<serial>.tmp-<pid>`` first; a manifest
    naming every file is written and fsynced; then the directory is
    renamed into place. A crash at any point leaves the previous complete
    serial or a temp dir every reader ignores."""
    step_dir = os.path.join(checkpoint_dir, "checkpoint_%d" % serial)
    tmp_dir = "%s.tmp-%d" % (step_dir, os.getpid())
    shutil.rmtree(tmp_dir, ignore_errors=True)
    try:
        save_persistables(executor, tmp_dir, main_program=main_program,
                          scope=scope)
        manifest = {"manifest_version": 1, "serial": int(serial),
                    "files": sorted(f for f in os.listdir(tmp_dir)
                                    if f != _CKPT_MANIFEST)}
        with open(os.path.join(tmp_dir, _CKPT_MANIFEST), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        shutil.rmtree(step_dir, ignore_errors=True)  # re-save same serial
        os.replace(tmp_dir, step_dir)
    except BaseException:
        shutil.rmtree(tmp_dir, ignore_errors=True)
        raise
    serials = _checkpoint_serials(checkpoint_dir)
    # never prune the serial just written, whatever its ordering
    older = [s for s in serials if s != serial]
    for s in older[:max(len(serials) - max(int(max_num_checkpoints), 1), 0)]:
        shutil.rmtree(os.path.join(checkpoint_dir, "checkpoint_%d" % s),
                      ignore_errors=True)
    return step_dir


def load_checkpoint(executor, checkpoint_dir, main_program=None, scope=None,
                    serial=None):
    """Load the given (default: the newest) complete serial; returns the
    serial loaded, or None when the directory holds no complete
    checkpoint (io.py:679 parity). A serial the JAX package saved with
    vars split into shards is refused: assembling shards is ROADMAP
    A10's."""
    if not os.path.isdir(checkpoint_dir):
        return None
    serials = _checkpoint_serials(checkpoint_dir)
    if not serials:
        return None
    serial = serial if serial is not None else serials[-1]
    step_dir = os.path.join(checkpoint_dir, "checkpoint_%d" % serial)
    sharding = os.path.join(step_dir, _SHARDING)
    if os.path.exists(sharding):
        with open(sharding) as f:
            sharded = sorted(json.load(f))
        if sharded:
            raise NotImplementedError(
                "checkpoint %s holds vars saved in shards (%s); loading "
                "shards is not ported yet (ROADMAP A10)"
                % (step_dir, ", ".join(sharded)))
    load_persistables(executor, step_dir, main_program=main_program,
                      scope=scope)
    return serial
