"""The port stands alone: no file of it, and not chip_smoke.py, imports
JAX or the JAX package; importing every port module loads neither; and
its own copies of the framework-neutral host modules stay equal to the
JAX package's (presets, LossConfig, TrainConfig, the category tables, the
NumPy mAP oracle, the COCO evaluator, the native host cores' C++)."""

import ast
import dataclasses
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest

from vision_transformer_detector_tpu import config as jax_config
from vision_transformer_detector_tpu.data import categories as jax_categories
from vision_transformer_detector_tpu.metrics import (
    mean_average_precision as jax_map)
from vision_transformer_detector_tpu_torch import config as port_config
from vision_transformer_detector_tpu_torch.data import (
    categories as port_categories)
from vision_transformer_detector_tpu_torch.metrics import (
    mean_average_precision as port_map)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = "vision_transformer_detector_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "vision_transformer_detector_tpu")


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, PORT)):
        files += [os.path.join(root, n) for n in sorted(names)
                  if n.endswith(".py")]
    return files


def _module_names():
    names = []
    for path in _port_files()[1:]:
        rel = os.path.relpath(path, REPO)[:-3].replace(os.sep, ".")
        names.append(rel[:-len(".__init__")] if rel.endswith(".__init__")
                     else rel)
    return names


def _imported(path):
    """Absolute module names a file imports (relative imports resolve
    inside the port and are skipped)."""
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_port_file_imports_jax_or_the_jax_package():
    files = _port_files()
    assert len(files) > 20
    bad = {}
    for path in files:
        hits = [name for name in _imported(path)
                if name.split(".")[0] in FORBIDDEN]
        if hits:
            bad[os.path.relpath(path, REPO)] = hits
    assert not bad, bad


def test_importing_every_port_module_loads_neither():
    script = (
        "import importlib, json, sys\n"
        f"names = {_module_names()!r}\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "foreign = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(json.dumps({'modules': len(names), 'foreign': foreign}))\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["modules"] > 20
    assert result["foreign"] == []


# The port's scripts beside the package: tools/*_torch.py and
# examples/*_torch.py (the .keras converter, the walkthrough, the overlay
# tool, the profilers, the overfit demo).
SCRIPTS = ("tools/convert_tf_checkpoint_torch.py",
           "tools/overlay_overfit_torch.py",
           "examples/end_to_end_torch.py")


def _script_files():
    return sorted(os.path.join(REPO, folder, name)
                  for folder in ("tools", "examples")
                  for name in os.listdir(os.path.join(REPO, folder))
                  if name.endswith("_torch.py"))


def test_no_port_script_imports_jax_or_the_jax_package():
    files = _script_files()
    assert {os.path.join(REPO, name) for name in SCRIPTS} <= set(files)
    bad = {}
    for path in files:
        hits = [name for name in _imported(path)
                if name.split(".")[0] in FORBIDDEN]
        if hits:
            bad[os.path.relpath(path, REPO)] = hits
    assert not bad, bad


def test_loading_every_port_script_loads_neither():
    """Each script's module body (imports, definitions; not its main) in
    one process with JAX blocked: nothing of JAX or the JAX package is
    loaded, and the .keras converter and the overlay tool reach the
    port's model and plotting modules."""
    script = (
        "import json, runpy, sys\n"
        f"for name in {FORBIDDEN!r}:\n"
        "    sys.modules[name] = None\n"
        f"paths = {_script_files()!r}\n"
        "for path in paths:\n"
        "    runpy.run_path(path, run_name='loaded')\n"
        "sys.path.insert(0, 'tools')\n"
        "import convert_tf_checkpoint_torch as c, overlay_overfit_torch\n"
        "from vision_transformer_detector_tpu_torch import config\n"
        "shapes = c.target_shapes(config.get_config('tiny_96'))\n"
        "foreign = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r} and sys.modules[m] is not None)\n"
        "print(json.dumps({'scripts': len(paths), 'foreign': foreign,\n"
        "                  'names': len(shapes)}))\n")
    proc = subprocess.run([sys.executable, "-c", script], cwd=REPO,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["scripts"] >= len(SCRIPTS)
    assert result["foreign"] == [] and result["names"] > 20


def _fields(obj):
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}


@pytest.mark.parametrize("name", sorted(jax_config.PRESETS))
def test_presets_equal_the_jax_ones(name):
    assert sorted(port_config.PRESETS) == sorted(jax_config.PRESETS)
    port, ref = port_config.get_config(name), jax_config.get_config(name)
    assert _fields(port) == _fields(ref)
    for prop in ("grid_size", "num_patches", "patch_dim",
                 "encoder_mlp_units", "head_units"):
        assert getattr(port, prop) == getattr(ref, prop), prop


@pytest.mark.parametrize("cls", ["DetectorConfig", "LossConfig",
                                 "TrainConfig"])
def test_config_classes_equal_the_jax_ones(cls):
    port, ref = getattr(port_config, cls)(), getattr(jax_config, cls)()
    assert [f.name for f in dataclasses.fields(port)] == [
        f.name for f in dataclasses.fields(ref)]
    assert _fields(port) == _fields(ref)
    for const in ("EPSILON", "EMPTY_SLOT_VALUE", "OBJECTNESS_THRESHOLD",
                  "CLASSIFICATION_CONFIDENCE_THRESHOLD"):
        assert getattr(port_config, const) == getattr(jax_config, const)


def test_config_files_round_trip_between_the_packages(tmp_path):
    """A config.json written by one package loads in the other."""
    detector = jax_config.get_config("vit_b16_384")
    path = str(tmp_path / "config.json")
    jax_config.save_configs(path, detector, jax_config.LossConfig(),
                            jax_config.TrainConfig(batch_size=4))
    port, loss, train = port_config.load_configs(path)
    assert _fields(port) == _fields(detector)
    assert _fields(loss) == _fields(port_config.LossConfig())
    assert train.batch_size == 4


def test_category_tables_equal_the_jax_ones():
    public = [name for name in dir(jax_categories)
              if name.isupper() and not name.startswith("_")]
    assert public
    for name in public:
        assert getattr(port_categories, name) == getattr(jax_categories,
                                                         name), name


@pytest.mark.parametrize("seed", [0, 1])
def test_map_oracle_gives_the_jax_result(seed):
    """The port's copy of the NumPy mAP oracle and the JAX package's, on
    the same seeded labels and jittered predictions."""
    config = jax_config.DetectorConfig(image_size=(96, 96), num_classes=6)
    rng = np.random.default_rng(seed)
    port, ref = (port_map.MeanAveragePrecision(config),
                 jax_map.MeanAveragePrecision(config))
    for _ in range(3):
        labels = np.full((4, config.max_objects, 6), -8.0, np.float32)
        labels[..., 0] = 0.0
        for i in range(4):
            for s in range(int(rng.integers(1, 4))):
                labels[i, s] = (1, rng.integers(0, 6), rng.uniform(20, 76),
                                rng.uniform(20, 76), rng.uniform(8, 30),
                                rng.uniform(8, 30))
        preds = labels.copy()
        real = labels[..., 0] > 0
        preds[real, 0] = rng.uniform(0.3, 1.0, real.sum())
        preds[real, 2:] += rng.uniform(-3, 3, (real.sum(), 4))
        for metric in (port, ref):
            metric.update_state(labels, preds,
                                use_transform_predictions=False)
    want = float(ref.result())
    assert want > 0.0
    assert float(port.result()) == want


# ---------------------------------------------------------------------------
# Own copies of framework-neutral modules: the code equal to the JAX
# package's, statement for statement (module docstrings aside)

def _body(path):
    """The module's statements without its docstring, as AST dumps."""
    tree = ast.parse(open(path).read())
    body = tree.body
    if body and isinstance(body[0], ast.Expr) and isinstance(
            getattr(body[0], "value", None), ast.Constant):
        body = body[1:]
    return [ast.dump(node) for node in body]


@pytest.mark.parametrize("module", ["utils/visualize.py",
                                    "utils/plotting.py",
                                    "data/statistics.py"])
def test_neutral_copies_equal_the_jax_modules(module):
    ref = os.path.join(REPO, "vision_transformer_detector_tpu", module)
    port = os.path.join(REPO, PORT, module)
    assert _body(port) == _body(ref)


def _definitions(path):
    """name (``Class.method`` for methods) -> AST dump of each top-level
    function and class method, and of each other top-level statement."""
    out = {}
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, ast.ClassDef):
            for item in node.body:
                key = (f"{node.name}.{item.name}"
                       if isinstance(item, ast.FunctionDef)
                       else f"{node.name}:{ast.dump(item)}")
                out[key] = ast.dump(item)
        elif isinstance(node, ast.FunctionDef):
            out[node.name] = ast.dump(node)
        elif not (isinstance(node, ast.Expr)
                  and isinstance(node.value, ast.Constant)):
            out[ast.dump(node)] = ast.dump(node)
    return out


# The deliberate differences of the port's metrics/coco_eval.py:
COCO_EVAL_REPAIRS = {
    # an unevaluated AP50/AP75 is -1.0, as in pycocotools (JAX: None)
    "CocoEvalResults.summarize",
    # eval_step gets uint8 canvases on the model's device, stated, and its
    # output is checked; the steps run in torch
    "evaluate_coco_protocol_original_frame", "evaluate_coco_protocol",
}
COCO_EVAL_PORT_ONLY = {"_device_of", "_run_eval_step"}
# The port's native matcher branches are the JAX copy's but for where the
# core comes from (the port's own, built at its first use, instead of the
# try-import of an extension built at import) and the message of a core
# that is not built: these edits, undone, give the JAX statements.
COCO_EVAL_NATIVE_EDITS = (
    ("from .._native import _native_coco_eval\n",
     "try:\n"
     "    from .._native import _native_coco_eval  # type: ignore\n"
     "except Exception:  # pragma: no cover - extension not built\n"
     "    _native_coco_eval = None\n"),
    ("    return _native_coco_eval.available()\n",
     "    return _native_coco_eval is not None\n"),
    ('                "use_native=True but the native matcher core is not '
     'built "\n'
     '                "(`vtd-torch doctor` says why)")\n',
     '                "use_native=True but the native matcher extension is '
     'not "\n'
     '                "built (tools/build_native.sh)")\n'),
)
COCO_EVAL_NATIVE = ("native_matcher_available", "CocoEvaluator.__init__",
                    "CocoEvaluator._evaluate_image")


def _coco_eval_definitions(tmp_path):
    """(JAX, port with the native edits undone) definitions of
    metrics/coco_eval.py."""
    source = open(os.path.join(REPO, PORT, "metrics", "coco_eval.py")).read()
    for port_text, jax_text in COCO_EVAL_NATIVE_EDITS:
        assert source.count(port_text) == 1, port_text
        source = source.replace(port_text, jax_text)
    undone = tmp_path / "coco_eval.py"
    undone.write_text(source)
    return (_definitions(os.path.join(REPO, "vision_transformer_detector_tpu",
                                      "metrics", "coco_eval.py")),
            _definitions(str(undone)))


def test_coco_eval_core_equals_the_jax_copy_but_for_the_repairs(tmp_path):
    ref, port = _coco_eval_definitions(tmp_path)
    differ = {name for name in ref
              if name in port and port[name] != ref[name]}
    assert differ == COCO_EVAL_REPAIRS
    assert not {name for name in ref if name not in port}
    assert set(port) - set(ref) == COCO_EVAL_PORT_ONLY
    for name in ("iou_xywh", "_match_image", "ground_truth_from_labels",
                 "detections_from_decoded", "update_from_fixed_slots",
                 "score_coco_results", "CocoEvaluator.evaluate",
                 "CocoEvaluator._accumulate", "CocoEvaluator.add_image",
                 "CocoEvalResults.ap", "CocoEvalResults.ar",
                 "CocoEvalResults.per_category"):
        assert port[name] == ref[name], name


@pytest.mark.parametrize("name", COCO_EVAL_NATIVE)
def test_coco_eval_native_branches_equal_the_jax_copy(tmp_path, name):
    ref, port = _coco_eval_definitions(tmp_path)
    assert port[name] == ref[name]


# The port's native host cores (native/*.cc of the port): each one's
# anonymous namespace is the JAX package's native/<name>.cc namespace,
# statement for statement, without its CPython glue (the chunks, at brace
# depth 0 and split at blank lines, whose code names a Py* identifier
# other than Py_ssize_t).
_GLUE = re.compile(r"\bPy(?!_ssize_t\b)[A-Za-z_]\w*")


def _code(line):
    return line.split("//", 1)[0]


def _namespace_chunks(path):
    lines = open(path).read().split("\n")
    body = lines[lines.index("namespace {") + 1:lines.index("}  // namespace")]
    chunks, current, depth = [], [], 0
    for line in body:
        if not line.strip() and depth == 0:
            if current:
                chunks.append("\n".join(current))
            current = []
            continue
        current.append(line)
        code = re.sub(r"'(\\.|[^'\\])'", "''",
                      re.sub(r'"(\\.|[^"\\])*"', '""', _code(line)))
        depth += code.count("{") - code.count("}")
    if current:
        chunks.append("\n".join(current))
    return chunks


@pytest.mark.parametrize("name", ["coco_json", "coco_eval", "pipeline"])
def test_native_core_equals_the_jax_source_but_for_the_glue(name):
    ref = _namespace_chunks(os.path.join(REPO, "native", f"{name}.cc"))
    work = [c for c in ref
            if not any(_GLUE.search(_code(line)) for line in c.split("\n"))]
    assert len(work) < len(ref)     # the glue is there, and left out
    port = _namespace_chunks(os.path.join(REPO, PORT, "native", f"{name}.cc"))
    assert port == work
    assert not any("Python.h" in line for line in open(
        os.path.join(REPO, PORT, "native", f"{name}.cc")))


# The port's sweep runner: the JAX module but for where it builds the
# Trainer (which also takes a device): these two edits, undone, give the
# JAX module statement for statement.
SWEEP_PORT_EDITS = (
    ('        mesh=None,\n        device="cuda",\n', "        mesh=None,\n"),
    ("                          mesh=mesh, metrics_path=metrics_path,\n"
     "                          device=device)",
     "                          mesh=mesh, metrics_path=metrics_path)"),
)


def test_sweep_equals_the_jax_copy_but_for_the_trainer(tmp_path):
    source = open(os.path.join(REPO, PORT, "train", "sweep.py")).read()
    for port_text, jax_text in SWEEP_PORT_EDITS:
        assert source.count(port_text) == 1, port_text
        source = source.replace(port_text, jax_text)
    undone = tmp_path / "sweep.py"
    undone.write_text(source)
    assert _body(str(undone)) == _body(os.path.join(
        REPO, "vision_transformer_detector_tpu", "train", "sweep.py"))


def test_flops_estimate_equals_the_jax_copy():
    ref = _definitions(os.path.join(
        REPO, "vision_transformer_detector_tpu", "utils", "profiling.py"))
    port = _definitions(os.path.join(REPO, PORT, "utils", "profiling.py"))
    assert port["flops_estimate"] == ref["flops_estimate"]


@pytest.mark.parametrize("name", ["reference_608", "highres_1024",
                                  "vit_b16_384"])
def test_flops_estimate_gives_the_jax_value(name):
    from vision_transformer_detector_tpu.utils import profiling as jax_prof
    from vision_transformer_detector_tpu_torch.utils import (
        profiling as port_prof)

    config = port_config.get_config(name)
    assert port_prof.flops_estimate(config, 8) == jax_prof.flops_estimate(
        jax_config.get_config(name), 8)
