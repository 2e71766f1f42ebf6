"""Import hygiene of the PyTorch port, and chip_smoke.py's refusals.

The port imports torch and numpy only: importing every one of its modules
in a fresh interpreter must bring in neither ``jax`` nor the JAX package
``bifrost3d_tpu`` (which would also switch on its compile cache), nor
``triton``. chip_smoke.py must refuse to run without a CUDA card and
outside a checkout of the repository, and take its roofline yardstick
from the benchmark's harness.

Name hygiene, read from the sources with ``ast`` (neither package is
imported): every public top-level name of a JAX module (a function, a
class, an upper-case constant) has a counterpart in the same-named port
module, or is in ``TPU_ONLY`` with its reason; and every public JAX
function and class is a case of ``test_torch_public_parity*.py`` or in
``COVERED_ELSEWHERE``, whose named test must reach it.
"""

import ast
import glob
import importlib.util
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = """
import importlib, pkgutil, sys
import bifrost3d_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "bifrost3d_tpu", "triton"))
print(len(names), bad)
assert len(names) >= 72, names
for new in ("apps.smallpt_app", "integrator.smallpt", "integrator.smallvpt",
            "integrator.pallas_smallpt", "scene.spheres", "scene.media",
            "math.morton", "geometry.bvh", "geometry.native",
            "geometry.pallas_bvh", "geometry.pallas_bvh_vmem",
            "geometry.pallas_clustered", "sampling.pmj",
            "math.distribution1d", "math.distribution2d",
            "lights.environment", "io.texture", "diff", "diff.render_grad",
            "diff.edge_grad", "diff.mesh_edge_grad", "utils.tree",
            "io.image", "io.compare", "io.native_obj", "io.obj", "io.gltf",
            "io.pixel_image", "integrator.aov", "apps.simple_viewer",
            "integrator.backend", "utils.checkpoint", "utils.profiling",
            "preview", "preview.renderer", "preview.ibl", "preview.ssao",
            "apps.environment_convolution", "core", "core.uid",
            "core.bitmask", "core.changeset", "core.engine", "core.input",
            "core.compositor", "scene.datamodel",
            "apps.interactive_viewer", "parallel", "parallel.mesh",
            "parallel.render", "parallel.distributed", "math.statistics",
            "math.nelder_mead", "math.geometry2d3d", "math.ltc",
            "shading.ltc_fit", "bsdf.burley_sss", "apps.dev_analysis",
            "utils.hostbuild"):
    assert pkg.__name__ + "." + new in names, new
assert not bad, bad
"""

_NATIVE_BUILD = """
import os, sys
from bifrost3d_tpu_torch.geometry import native
opened = []
sys.addaudithook(lambda event, args: opened.append(str(args[0]))
                 if event == "open" else None)
available = native.native_available()
jax_dir = os.path.join(native.REPO_DIR, "bifrost3d_tpu") + os.sep
bad = [p for p in opened if os.path.abspath(p).startswith(jax_dir)]
print(available, native.library_path(), bad)
assert not bad, bad
assert native.library_path().startswith(os.path.join(native.REPO_DIR, "build"))
assert "jax" not in sys.modules and "bifrost3d_tpu" not in sys.modules
"""


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_port_imports_neither_jax_nor_the_jax_package():
    proc = _run(["-c", _IMPORT_ALL], REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_native_builder_opens_nothing_of_the_jax_package():
    proc = _run(["-c", _NATIVE_BUILD], REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_chip_smoke_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: chip_smoke.py would run")
    proc = _run(["chip_smoke.py"], REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_refuses_outside_the_repository(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(["chip_smoke.py"], str(tmp_path))
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_takes_the_benchmark_yardstick():
    from benchmark.harness import profiling, roofline
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_yardstick", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)          # main() runs only as a script
    for name in ("shade_ops", "least_time_s", "PEAK_FLOPS", "PEAK_BYTES",
                 "MT_FLOPS", "BOX_FLOPS"):
        assert getattr(smoke, name) is getattr(roofline, name), name
    assert smoke.spin is profiling.spin
    # No copy of the counts or of the spin marker is left beside them.
    for name in ("MEGA_SHADE_OPS", "MEGA_RIS_OPS", "MEGA_COAT_OPS",
                 "MEGA_COAT_RIS_OPS", "MEGA_EXTRAS_OPS", "SPHERE_FLOPS",
                 "SMALLPT_SHADE_FLOPS", "_spin"):
        assert not hasattr(smoke, name), name


# -- public names --------------------------------------------------------------------

JAX_ROOT = os.path.join(REPO, "bifrost3d_tpu")
PORT_ROOT = os.path.join(REPO, "bifrost3d_tpu_torch")
TESTS = os.path.join(REPO, "tests")

# JAX names with no port counterpart, keyed ``module.NAME``: each is a
# Pallas tiling or kernel-body constant, or a switch between JAX's own
# fallbacks, that the CUDA kernels and the port's dispatch replace.
TPU_ONLY = {
    "geometry.pallas_bvh.BLOCK_R":
        "Pallas rays per grid step; the CUDA kernels size their own blocks",
    "geometry.pallas_bvh.GROUP_R":
        "rays per VPU sub-group of a Pallas block; a warp walks on the card",
    "geometry.pallas_bvh.CLUSTER_T":
        "triangles per DMA cluster; the port packs its own BVH "
        "(pack_hierarchical's leaves, bvh_walk.cuh)",
    "geometry.pallas_bvh.STACK":
        "the Pallas block's shared stack depth; the CUDA walk keeps its own "
        "(kStack in bvh_walk.cuh)",
    "geometry.pallas_bvh.TREELET_CUT":
        "the TPU cluster partition switch; the port's packing has one layout",
    "geometry.pallas_bvh_vmem.STACK":
        "the Pallas block's stack depth; vmem_intersect.cu keeps its own",
    "geometry.pallas_intersect.BLOCK_R":
        "Pallas rays per grid step; dense_intersect.cu sizes its blocks",
    "geometry.traverse.BRUTE_FORCE_MAX_TRIS":
        "JAX's switch between its jnp scan and jnp BVH walk where no Pallas "
        "table applies; the port's scene carries a kernel table "
        "(traverse.PALLAS_MAX_TRIS) and dispatches on it",
    "integrator.pallas_mesh.LANES":
        "the (8, 128) VPU tile of the Pallas megakernel; the CUDA megakernel "
        "runs a pixel per thread (_THREADS)",
    "integrator.pallas_mesh.PI":
        "a literal of the Pallas kernel body; mesh_megakernel.cu has its own",
    "integrator.pallas_mesh.TWO_PI":
        "a literal of the Pallas kernel body; mesh_megakernel.cu has its own",
    "integrator.pallas_mesh.INV_PI":
        "a literal of the Pallas kernel body; mesh_megakernel.cu has its own",
    "integrator.pallas_mesh.MIN_ALPHA":
        "the Pallas kernel body's GGX floor; kMinAlpha in mesh_megakernel.cu "
        "and bsdf.ggx.MIN_ALPHA in the plain version",
    "integrator.pallas_mesh.HIER_CLUSTER":
        "triangles per DMA cluster of the TPU BVH branch; B3 walks the "
        "port's own packing",
    "integrator.pallas_mesh.HIER_STACK":
        "the TPU BVH branch's stack depth; bvh_walk.cuh keeps its own",
    "integrator.pallas_mesh.ATTR_DOT_SPLIT":
        "how the TPU kernel selects attribute rows on the MXU; the CUDA "
        "kernel indexes them",
    "integrator.pallas_smallpt.LANES":
        "the (8, 128) VPU tile of a Pallas block; smallpt_megakernel.cu runs "
        "persistent lanes",
}


def _modules(root):
    """``module.path`` → source file, for every module of a package."""
    out = {}
    for path in sorted(glob.glob(os.path.join(root, "**", "*.py"),
                                 recursive=True)):
        rel = os.path.relpath(path, root)[:-3].replace(os.sep, ".")
        out[rel] = path
    return out


def _bindings(path):
    """Top-level names of a module → "def", "class", "const" (assigned) or
    "import"."""
    out = {}
    for node in ast.parse(open(path).read()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = "def"
        elif isinstance(node, ast.ClassDef):
            out[node.name] = "class"
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for target in targets:
                for n in ast.walk(target):
                    if isinstance(n, ast.Name):
                        out.setdefault(n.id, "const")
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            for alias in node.names:
                out.setdefault((alias.asname or alias.name).split(".")[0],
                               "import")
    return out


def _jax_public():
    """``module.name`` → kind, for the JAX package's public functions,
    classes and upper-case constants."""
    out = {}
    for module, path in _modules(JAX_ROOT).items():
        for name, kind in _bindings(path).items():
            if name.startswith("_") or kind == "import":
                continue
            if kind == "const" and not name.isupper():
                continue
            out[f"{module}.{name}"] = kind
    return out


def test_every_jax_public_name_has_a_port_counterpart():
    """And every TPU_ONLY entry is a JAX name that the port lacks."""
    port = {m: _bindings(p) for m, p in _modules(PORT_ROOT).items()}

    def ported(key):
        module, name = key.rsplit(".", 1)
        return name in port.get(module, {})
    jax = _jax_public()
    missing = [key for key in jax if not ported(key) and key not in TPU_ONLY]
    assert not missing, missing
    stale = [key for key in TPU_ONLY if key not in jax or ported(key)]
    assert not stale, stale


# -- every public function and class has a test ----------------------------------------

_WORD = re.compile(r"\w+")
_KEY = re.compile(r"^[a-z_0-9]+(\.[A-Za-z_0-9]+)+$")


def _parity_cases():
    """The ``module.name`` keys of test_torch_public_parity*.py: the string
    handed to each ``case(...)`` (or ``_manager_case(...)``) call."""
    keys = set()
    for path in glob.glob(os.path.join(TESTS, "test_torch_public_parity*.py")):
        for node in ast.walk(ast.parse(open(path).read())):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                    and node.func.id.endswith("case") and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and isinstance(node.args[0].value, str)
                    and _KEY.match(node.args[0].value)):
                keys.add(node.args[0].value)
    return keys


def _test_reach(path):
    """test id → the words its code reaches: its own source (decorators
    included), and transitively the module-level helpers and tables of its
    file that it names, with an import's alias standing for the name it
    imports."""
    src = open(path).read()
    tree = ast.parse(src)

    def words(node):
        parts = [ast.get_source_segment(src, d)
                 for d in getattr(node, "decorator_list", [])]
        return set(_WORD.findall("\n".join(
            parts + [ast.get_source_segment(src, node)])))
    helpers, alias = {}, {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            helpers[node.name] = words(node)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for target in targets:
                for n in ast.walk(target):
                    if isinstance(n, ast.Name):
                        helpers[n.id] = words(node)
        elif isinstance(node, ast.ImportFrom):
            for a in node.names:
                if a.asname:
                    alias.setdefault(a.asname, set()).add(a.name)

    def reach(start):
        seen, todo = set(), list(start)
        while todo:
            w = todo.pop()
            if w not in seen:
                seen.add(w)
                seen |= alias.get(w, set())
                todo.extend(helpers.get(w, ()))
        return seen
    out = {}
    for node in tree.body:
        if isinstance(node, ast.FunctionDef) and node.name.startswith("test"):
            out[node.name] = reach(helpers[node.name])
        elif isinstance(node, ast.ClassDef) and node.name.startswith("Test"):
            for sub in node.body:
                if (isinstance(sub, ast.FunctionDef)
                        and sub.name.startswith("test")):
                    out[f"{node.name}::{sub.name}"] = reach(
                        words(sub) | {node.name})
    return out


def test_every_jax_public_function_is_tested():
    """A public JAX function or class is a parity case, or its entry in
    ``COVERED_ELSEWHERE`` names a test that reaches its name (or the word
    after ``via``: the table key it is reached by)."""
    cases = _parity_cases()
    functions = {k for k, kind in _jax_public().items()
                 if kind in ("def", "class")}
    assert cases <= functions, sorted(cases - functions)
    assert not cases & set(COVERED_ELSEWHERE), sorted(
        cases & set(COVERED_ELSEWHERE))
    untested = sorted(functions - cases - set(COVERED_ELSEWHERE))
    assert not untested, untested
    stale = sorted(set(COVERED_ELSEWHERE) - functions)
    assert not stale, stale
    reach = {}
    for key, where in COVERED_ELSEWHERE.items():
        test, _, via = where.partition(" via ")
        filename, test_id = test.split("::", 1)
        if filename not in reach:
            reach[filename] = _test_reach(os.path.join(TESTS, filename))
        assert test_id in reach[filename], (key, where)
        assert (via or key.rsplit(".", 1)[1]) in reach[filename][test_id], (
            key, where)


# Public JAX functions and classes that are no case of the parity files,
# each with the test that holds it against JAX (file::test, with the table
# key it is reached by after "via" where the test reaches it by a key).
# Made as the parity list was: the first test that reaches the name, a
# CPU test before a CUDA one.
COVERED_ELSEWHERE = {
    "apps.dev_analysis.main":
        "test_torch_aux_modules.py::test_dev_analysis_cli_on_the_cpu",
    "apps.dev_analysis.normals_analysis":
        "test_torch_aux_modules.py::test_normals_analysis_matches_jax",
    "apps.dev_analysis.seeding_analysis":
        "test_torch_aux_modules.py::test_seeding_analysis_matches_jax",
    "apps.dev_analysis.sss_analysis":
        "test_torch_aux_modules.py::test_sss_analysis_matches_jax",
    "apps.environment_convolution.main":
        "test_torch_viewer_modes.py::"
        "test_environment_convolution_matches_jax_app",
    "apps.interactive_viewer.CameraNavigation":
        "test_torch_interactive_viewer.py::test_camera_navigation_matches_jax",
    "apps.interactive_viewer.RenderingPanel":
        "test_torch_interactive_viewer.py::test_panel_rows_match_jax",
    "apps.interactive_viewer.build_scene":
        "test_torch_interactive_viewer.py::test_panel_rows_match_jax",
    "apps.interactive_viewer.frame_to_ansi":
        "test_torch_interactive_viewer.py::test_frame_to_ansi_equals_jax",
    "apps.interactive_viewer.main":
        "test_torch_interactive_viewer.py::test_main_defaults_to_the_card",
    "apps.interactive_viewer.run":
        "test_torch_interactive_viewer.py::"
        "test_headless_run_prints_what_jax_prints",
    "apps.scenes.create_cornell_box":
        "test_torch_viewer_scenes.py::test_builders_take_jax_arguments",
    "apps.scenes.create_glass_scene":
        "test_torch_viewer_scenes.py::test_new_builders_match_jax via Glass",
    "apps.scenes.create_legacy_material_scene":
        "test_torch_viewer_scenes.py::"
        "test_new_builders_match_jax via MaterialSceneLegacy",
    "apps.scenes.create_material_scene":
        "test_torch_viewer_scenes.py::"
        "test_material_scene_loads_the_shader_ball",
    "apps.scenes.create_opacity_scene":
        "test_torch_megakernel_extras.py::test_settings_for_scene_match_jax",
    "apps.scenes.create_sphere_light_scene":
        "test_torch_megakernel.py::test_packed_tables_match_jax",
    "apps.scenes.create_sphere_scene":
        "test_torch_megakernel_extras.py::test_settings_for_scene_match_jax",
    "apps.scenes.create_test_scene":
        "test_torch_viewer_scenes.py::test_new_builders_match_jax via Test",
    "apps.scenes.create_veach_scene":
        "test_torch_megakernel.py::test_packed_tables_match_jax",
    "apps.simple_viewer.build_scene_from_file":
        "test_torch_viewer_files.py::test_file_camera_has_aspect_one",
    "apps.simple_viewer.main":
        "test_torch_faults.py::test_viewer_camera_flags_match_jax",
    "apps.smallpt_app.main": "test_torch_smallpt.py::test_app_writes_a_png",
    "apps.smallpt_app.render_progressive":
        "test_torch_smallpt.py::test_app_defaults_to_cuda_and_flips_rows",
    "bsdf.burley.evaluate": "test_torch_aux_modules.py::test_line_matches_jax",
    "bsdf.burley.evaluate_scalar":
        "test_torch_transmissive.py::test_lambert_and_burley",
    "bsdf.burley.evaluate_with_pdf":
        "test_torch_transmissive.py::test_lambert_and_burley",
    "bsdf.burley.pdf": "test_torch_transmissive.py::test_lambert_and_burley",
    "bsdf.burley.sample":
        "test_torch_transmissive.py::test_lambert_and_burley",
    "bsdf.burley_sss.Parameters":
        "test_torch_aux_modules.py::"
        "test_burley_parameters_and_evaluate_match_jax",
    "bsdf.burley_sss.evaluate":
        "test_torch_aux_modules.py::"
        "test_burley_parameters_and_evaluate_match_jax",
    "bsdf.burley_sss.evaluate_profile":
        "test_torch_aux_modules.py::test_burley_profile_matches_jax",
    "bsdf.burley_sss.sample_diffusion_profile":
        "test_torch_aux_modules.py::test_burley_exact_sampler_matches_jax",
    "bsdf.burley_sss.sample_diffusion_profile_approximation":
        "test_torch_aux_modules.py::"
        "test_burley_approximate_sampler_matches_jax",
    "bsdf.fresnel.adjust_conductor_specularity_to_exterior_medium":
        "test_torch_bsdf.py::test_fresnel",
    "bsdf.fresnel.adjust_dielectric_specularity_to_exterior_medium":
        "test_torch_bsdf.py::test_fresnel",
    "bsdf.fresnel.dielectric_schlick_fresnel":
        "test_torch_transmissive.py::test_refract_and_dielectric_fresnel",
    "bsdf.fresnel.dielectric_specularity": "test_torch_bsdf.py::test_fresnel",
    "bsdf.fresnel.schlick_fresnel": "test_torch_bsdf.py::test_fresnel",
    "bsdf.ggx.alpha_from_roughness": "test_torch_bsdf.py::test_ggx_reflection",
    "bsdf.ggx.evaluate": "test_torch_transmissive.py::test_ggx_combined_lobe",
    "bsdf.ggx.evaluate_with_pdf":
        "test_torch_transmissive.py::test_ggx_combined_lobe",
    "bsdf.ggx.pdf": "test_torch_transmissive.py::test_vndf",
    "bsdf.ggx.r_evaluate_with_pdf": "test_torch_bsdf.py::test_ggx_reflection",
    "bsdf.ggx.r_sample": "test_torch_bsdf.py::test_ggx_reflection",
    "bsdf.ggx.sample": "test_torch_transmissive.py::test_ggx_combined_lobe",
    "bsdf.ggx.t_evaluate":
        "test_torch_transmissive.py::test_ggx_transmission_lobe",
    "bsdf.ggx.t_evaluate_with_pdf":
        "test_torch_transmissive.py::test_ggx_transmission_lobe",
    "bsdf.ggx.t_pdf": "test_torch_transmissive.py::test_ggx_transmission_lobe",
    "bsdf.ggx.t_sample":
        "test_torch_transmissive.py::test_ggx_transmission_lobe",
    "bsdf.lambert.evaluate":
        "test_torch_aux_modules.py::test_line_matches_jax",
    "bsdf.lambert.evaluate_with_pdf":
        "test_torch_transmissive.py::test_lambert_and_burley",
    "bsdf.lambert.pdf": "test_torch_transmissive.py::test_lambert_and_burley",
    "bsdf.lambert.sample":
        "test_torch_transmissive.py::test_lambert_and_burley",
    "bsdf.oren_nayar.evaluate":
        "test_torch_aux_modules.py::test_line_matches_jax",
    "bsdf.oren_nayar.evaluate_scalar":
        "test_torch_transmissive.py::test_lambert_and_burley",
    "bsdf.oren_nayar.evaluate_with_pdf": "test_torch_bsdf.py::test_oren_nayar",
    "bsdf.oren_nayar.pdf":
        "test_torch_environment.py::"
        "test_build_environment_light_tables_match_jax",
    "bsdf.oren_nayar.sample": "test_torch_bsdf.py::test_oren_nayar",
    "bsdf.types.BSDFSample":
        "test_torch_public_functions.py::test_invalidate_equals_jax",
    "bsdf.types.invalidate":
        "test_torch_public_functions.py::test_invalidate_equals_jax",
    "core.bitmask.Bitmask":
        "test_torch_core.py::TestBitmaskChangeSet::test_bitmask_queries",
    "core.changeset.ChangeSet":
        "test_torch_core.py::"
        "TestBitmaskChangeSet::test_changeset_accumulates_and_resets",
    "core.compositor.Compositor":
        "test_torch_compositor.py::test_compositor_frame_matches_jax",
    "core.compositor.Renderers":
        "test_torch_compositor.py::test_registry_names_and_ids",
    "core.engine.Engine":
        "test_torch_compositor.py::test_engine_attach_full_tick",
    "core.engine.Window": "test_torch_core.py::test_seeded_script_matches_jax",
    "core.input.Keyboard": "test_torch_core.py::TestInput::test_keyboard_taps",
    "core.input.Mouse": "test_torch_core.py::TestInput::test_mouse_delta",
    "core.uid.TypedUIDGenerator":
        "test_torch_core.py::test_seeded_script_matches_jax",
    "core.uid.UID": "test_torch_core.py::TestUID::test_generate_and_has",
    "diff.edge_grad.direct_emission_image":
        "test_torch_diff_edges.py::test_direct_emission_matches_jax",
    "diff.edge_grad.edge_position_gradient":
        "test_torch_diff_edges.py::"
        "test_single_sphere_edge_gradient_matches_jax_and_fd",
    "diff.edge_grad.screen_coords":
        "test_torch_diff_edges.py::"
        "test_silhouette_and_screen_coords_match_jax",
    "diff.edge_grad.silhouette_direction":
        "test_torch_diff_edges.py::"
        "test_silhouette_and_screen_coords_match_jax",
    "diff.edge_grad.smallpt_position_gradient":
        "test_torch_diff_edges.py::"
        "test_smallpt_position_gradient_matches_jax_and_fd",
    "diff.mesh_edge_grad.MeshEdges":
        "test_torch_diff_edges.py::test_mesh_edges_match_jax",
    "diff.mesh_edge_grad.edge_translation_gradient":
        "test_torch_diff_edges.py::"
        "test_box_translation_gradient_matches_jax_and_fd",
    "diff.mesh_edge_grad.edge_vertex_gradient":
        "test_torch_diff_edges.py::"
        "test_vertex_gradient_matches_jax_and_translation_sum",
    "diff.mesh_edge_grad.shadow_edge_translation_gradient":
        "test_torch_diff_edges.py::"
        "test_shadow_edge_gradient_matches_jax_and_fd",
    "diff.render_grad.optimize_materials":
        "test_torch_diff_optimize.py::test_optimize_materials_recovers_tint",
    "diff.render_grad.render_loss_grad":
        "test_torch_parallel_train.py::test_sharded_gradient_equals_unsharded",
    "geometry.bvh.BVH": "test_torch_bvh.py::test_bvh_carried_from_jax",
    "geometry.bvh.build_bvh": "test_torch_bvh.py::test_build_bvh_matches_jax",
    "geometry.bvh.refit_bvh": "test_torch_bvh.py::test_refit_bvh_matches_jax",
    "geometry.creation.make_beveled_box":
        "test_torch_public_functions.py::test_creation_matches_jax",
    "geometry.creation.make_box":
        "test_torch_public_functions.py::test_mesh_utilities_match_jax",
    "geometry.creation.make_cylinder":
        "test_torch_datamodel.py::test_render_scene_equals_jax",
    "geometry.creation.make_plane":
        "test_torch_bvh.py::test_torus_and_combine_match_jax",
    "geometry.creation.make_sphere":
        "test_torch_public_functions.py::test_mesh_utilities_match_jax",
    "geometry.creation.make_spherical_box":
        "test_torch_public_functions.py::test_creation_matches_jax",
    "geometry.creation.make_torus":
        "test_torch_bvh.py::test_torus_and_combine_match_jax",
    "geometry.mesh.TriangleMesh":
        "test_torch_public_functions.py::test_mesh_utilities_match_jax",
    "geometry.mesh.combine_meshes":
        "test_torch_bvh.py::test_torus_and_combine_match_jax",
    "geometry.mesh.compute_hard_normals":
        "test_torch_public_functions.py::test_mesh_utilities_match_jax",
    "geometry.mesh.count_degenerate_primitives":
        "test_torch_public_functions.py::test_mesh_utilities_match_jax",
    "geometry.mesh.expand_indexed_buffers":
        "test_torch_public_functions.py::test_mesh_utilities_match_jax",
    "geometry.mesh.merge_duplicate_vertices":
        "test_torch_public_functions.py::test_mesh_utilities_match_jax",
    "geometry.mesh.normals_correspond_to_winding_order":
        "test_torch_public_functions.py::test_mesh_utilities_match_jax",
    "geometry.mesh.transform_mesh":
        "test_torch_viewer_files.py::test_build_scene_from_file_matches_jax",
    "geometry.native.native_available":
        "test_torch_bvh.py::"
        "test_native_and_numpy_trees_trace_to_the_same_hits",
    "geometry.pallas_bvh.HierTriangles":
        "test_torch_megakernel_hier.py::test_packed_tables_match_jax",
    "geometry.pallas_bvh.hierarchical_intersect":
        "test_torch_bvh.py::test_hierarchical_intersect_matches_jax_kernel",
    "geometry.pallas_bvh.hierarchical_intersect_sorted":
        "test_torch_bvh.py::test_hierarchical_sorted_matches_jax_kernel",
    "geometry.pallas_bvh.pack_hierarchical":
        "test_torch_bvh.py::test_packing_layout",
    "geometry.pallas_bvh_vmem.VmemTriangles":
        "test_torch_bvh_vmem.py::"
        "test_packing_builds_its_own_tree_and_carries_jax_packing",
    "geometry.pallas_bvh_vmem.fits_vmem":
        "test_torch_bvh_vmem.py::test_fits_vmem_matches_jax",
    "geometry.pallas_bvh_vmem.pack_vmem":
        "test_torch_bvh_vmem.py::"
        "test_packing_builds_its_own_tree_and_carries_jax_packing",
    "geometry.pallas_bvh_vmem.vmem_intersect":
        "test_torch_bvh_vmem.py::test_plain_version_matches_jax_kernel",
    "geometry.pallas_clustered.ClusteredTriangles":
        "test_torch_clustered.py::"
        "test_packing_builds_its_own_tree_and_carries_jax_packing",
    "geometry.pallas_clustered.clustered_intersect":
        "test_torch_clustered.py::test_plain_version_matches_jax_kernel",
    "geometry.pallas_clustered.pack_clustered":
        "test_torch_clustered.py::"
        "test_packing_builds_its_own_tree_and_carries_jax_packing",
    "geometry.pallas_intersect.pack_triangles":
        "test_torch_bvh.py::test_scene_dispatch",
    "geometry.pallas_intersect.pallas_intersect":
        "test_torch_culled_trace.py::"
        "test_dense_cull_and_full_scan_match_jax_kernel",
    "geometry.traverse.Hit":
        "test_torch_wavefront_extras.py::"
        "test_shadow_transmittance_matches_jax",
    "geometry.traverse.intersect_bvh":
        "test_torch_bvh.py::"
        "test_native_and_numpy_trees_trace_to_the_same_hits",
    "geometry.traverse.intersect_bvh_any":
        "test_torch_bvh.py::test_intersect_bvh_any_matches_jax",
    "geometry.traverse.intersect_scene":
        "test_torch_bvh.py::test_scene_dispatch",
    "geometry.traverse.intersect_scene_any":
        "test_torch_bvh.py::test_scene_dispatch",
    "geometry.traverse.intersect_triangles_brute":
        "test_torch_bvh_vmem.py::test_plain_version_matches_jax_kernel",
    "geometry.traverse.moller_trumbore":
        "test_torch_intersect.py::test_moller_trumbore_matches_jax",
    "integrator.aov.render_aovs":
        "test_torch_viewer_files.py::test_render_aovs_matches_jax",
    "integrator.backend.DenoisedBackend":
        "test_torch_backend.py::test_should_denoise_cadence",
    "integrator.backend.SimpleBackend":
        "test_torch_backend.py::test_simple_backend_is_the_running_mean",
    "integrator.backend.atrous_denoise":
        "test_torch_backend.py::test_atrous_denoise_matches_jax",
    "integrator.pallas_mesh.megakernel_ineligibility_reasons":
        "test_torch_faults.py::test_replaced_transmissive_material_raises",
    "integrator.pallas_mesh.mesh_megakernel_eligible":
        "test_torch_faults.py::test_replaced_diffuse_materials_match_jax",
    "integrator.pallas_mesh.prewarm_megakernel":
        "test_torch_megakernel.py::test_prewarm_fills_the_caches",
    "integrator.pallas_mesh.render_mesh_megakernel":
        "test_torch_megakernel_trace.py::"
        "test_frame_caches_skip_the_host_after_the_first_frame",
    "integrator.pallas_smallpt.render_smallpt_megakernel":
        "test_torch_smallpt.py::test_plain_megakernel_matches_jax_megakernel",
    "integrator.path_tracer.RenderSettings":
        "test_torch_backend.py::test_denoised_backend_matches_jax",
    "integrator.path_tracer.explain_render_path":
        "test_torch_bvh.py::test_forced_bvh_path_matches_jax_render",
    "integrator.path_tracer.mis_weight":
        "test_torch_lights.py::test_mis_weight",
    "integrator.path_tracer.render_pixels_pooled":
        "test_torch_distributed.py::test_multihost_render_at_world_size_one",
    "integrator.path_tracer.render_progressive":
        "test_torch_backend.py::test_simple_backend_is_the_running_mean",
    "integrator.path_tracer.render_rays":
        "test_torch_diff_replay.py::test_render_rays_matches_jax",
    "integrator.path_tracer.render_sample":
        "test_torch_datamodel.py::test_refit_matches_full_rebuild_render",
    "integrator.path_tracer.render_sample_fast":
        "test_torch_bvh.py::test_forced_bvh_path_matches_jax_render",
    "integrator.path_tracer.render_sample_pixels":
        "test_torch_diff_replay.py::test_render_sample_pixels_matches_jax",
    "integrator.path_tracer.render_sample_pooled":
        "test_torch_bvh.py::test_forced_bvh_path_matches_dense_path",
    "integrator.path_tracer.render_sample_pooled_counted":
        "test_torch_megakernel_extras.py::"
        "test_plain_megakernel_bvh_matches_port_wavefront",
    "integrator.path_tracer.settings_for_scene":
        "test_torch_bvh.py::test_forced_bvh_path_matches_jax_render",
    "integrator.smallpt.render_smallpt":
        "test_torch_smallpt.py::test_render_smallpt_is_the_running_mean",
    "integrator.smallpt.render_smallpt_accumulation":
        "test_torch_smallpt.py::test_accumulation_matches_jax",
    "integrator.smallpt.render_smallpt_pooled":
        "test_torch_smallpt.py::test_pooled_matches_jax_pooled",
    "integrator.smallpt.render_smallpt_pooled_counted":
        "test_torch_smallpt.py::test_pooled_matches_accumulation",
    "integrator.smallpt.smallpt_camera_ray":
        "test_torch_smallpt.py::test_camera_ray_matches_jax",
    "integrator.smallvpt.render_smallvpt_accumulation":
        "test_torch_smallpt.py::test_smallvpt_matches_jax",
    "io.compare.mssim":
        "test_torch_io_compare.py::test_identical_images_score_one",
    "io.compare.rms":
        "test_torch_io_compare.py::test_identical_images_score_one",
    "io.compare.ssim":
        "test_torch_io_compare.py::test_identical_images_score_one",
    "io.gltf.load_gltf": "test_torch_io_gltf.py::test_load_gltf_matches_jax",
    "io.image.load_exr":
        "test_torch_io_image.py::test_exr_round_trip_across_packages",
    "io.image.load_image":
        "test_torch_io_image.py::test_load_image_matches_jax",
    "io.image.save_exr":
        "test_torch_io_image.py::test_exr_round_trip_across_packages",
    "io.image.save_image":
        "test_torch_io_image.py::test_save_image_writes_exr_linear",
    "io.image.srgb_encode_u8":
        "test_torch_io_image.py::test_srgb_encode_u8_matches_jax",
    "io.native_obj.native_available":
        "test_torch_io_obj.py::test_native_library_builds_under_build_only",
    "io.native_obj.parse_obj_native":
        "test_torch_io_obj.py::test_native_library_builds_under_build_only",
    "io.obj.load_obj": "test_torch_io_obj.py::test_load_obj_matches_jax",
    "io.pixel_image.PixelImage":
        "test_torch_io_image.py::test_pixel_image_matches_jax",
    "io.pixel_image.channel_count":
        "test_torch_io_image.py::test_pixel_image_matches_jax",
    "io.pixel_image.is_byte_format":
        "test_torch_io_image.py::test_pixel_image_matches_jax",
    "io.texture.TextureBank":
        "test_torch_texture.py::test_bank_from_numpy_round_trip",
    "io.texture.fill_mipmaps":
        "test_torch_texture.py::test_fill_mipmaps_matches_jax",
    "io.texture.sample_texture":
        "test_torch_texture.py::test_empty_bank_matches_jax",
    "io.texture.sat_region_average":
        "test_torch_io_image.py::test_summed_area_table_matches_jax",
    "io.texture.summed_area_table":
        "test_torch_io_image.py::test_summed_area_table_matches_jax",
    "io.texture.unorm16_decode":
        "test_torch_texture.py::test_unorm_helpers_match_jax",
    "io.texture.unorm16_encode":
        "test_torch_texture.py::test_unorm_helpers_match_jax",
    "io.texture.unorm8_decode":
        "test_torch_texture.py::test_unorm_helpers_match_jax",
    "io.texture.unorm8_encode":
        "test_torch_texture.py::test_unorm_helpers_match_jax",
    "lights.analytic.evaluate_light":
        "test_torch_lights.py::test_light_sample_pdf_evaluate",
    "lights.analytic.is_delta_light":
        "test_torch_public_functions.py::test_is_delta_light_equals_jax",
    "lights.analytic.light_pdf":
        "test_torch_lights.py::test_light_sample_pdf_evaluate",
    "lights.analytic.sample_light":
        "test_torch_lights.py::test_light_sample_pdf_evaluate",
    "lights.environment.EnvironmentLight":
        "test_torch_megakernel_extras.py::"
        "test_ineligibility_reasons_equal_jax",
    "lights.environment.PresampledEnvironmentLight":
        "test_torch_wavefront_extras.py::"
        "test_one_sample_pool_disables_environment_nee",
    "lights.environment.build_environment_light":
        "test_torch_environment.py::"
        "test_build_environment_light_tables_match_jax",
    "lights.environment.direction_to_latlong_uv":
        "test_torch_environment.py::test_latlong_mappings_match_jax",
    "lights.environment.environment_evaluate":
        "test_torch_environment.py::test_environment_evaluate_matches_jax",
    "lights.environment.environment_pdf":
        "test_torch_environment.py::test_environment_pdf_matches_jax",
    "lights.environment.environment_sample":
        "test_torch_environment.py::test_environment_sample_matches_jax",
    "lights.environment.latlong_uv_to_direction":
        "test_torch_environment.py::test_latlong_mappings_match_jax",
    "lights.environment.presample_environment":
        "test_torch_environment.py::test_presampled_pool_matches_jax",
    "lights.environment.presampled_environment_sample":
        "test_torch_environment.py::test_presampled_pool_matches_jax",
    "lights.types.LightArray":
        "test_torch_bvh.py::test_refit_render_scene_follows_a_moved_instance",
    "math.color.hsv_to_rgb":
        "test_torch_public_functions.py::test_hsv_round_trip_anchored",
    "math.color.linear_to_srgb":
        "test_torch_io_image.py::test_linear_to_srgb_matches_jax",
    "math.color.rgb_to_hsv":
        "test_torch_public_functions.py::test_hsv_round_trip_anchored",
    "math.color.srgb_to_linear":
        "test_torch_environment.py::test_srgb_to_linear_matches_jax",
    "math.distribution1d.Distribution1D":
        "test_torch_environment.py::test_distribution1d_matches_jax",
    "math.distribution2d.Distribution2D":
        "test_torch_environment.py::test_distribution2d_build_matches_jax",
    "math.geometry2d3d.Line":
        "test_torch_aux_modules.py::test_line_matches_jax",
    "math.geometry2d3d.Plane":
        "test_torch_aux_modules.py::test_ray_plane_matches_jax",
    "math.geometry2d3d.Rect": "test_torch_aux_modules.py::test_rect",
    "math.geometry2d3d.intersect_ray_plane":
        "test_torch_aux_modules.py::test_ray_plane_matches_jax",
    "math.geometry2d3d.intersect_ray_sphere":
        "test_torch_aux_modules.py::test_ray_sphere_matches_jax",
    "math.geometry2d3d.sample_bilinear":
        "test_torch_aux_modules.py::test_image_sampling_matches_jax",
    "math.geometry2d3d.sample_trilinear":
        "test_torch_aux_modules.py::test_image_sampling_matches_jax",
    "math.ltc.IsotropicLTC": "test_torch_ltc.py::test_matrices_match_jax",
    "math.ltc.evaluate": "test_torch_ltc.py::test_pdf_matches_jax",
    "math.ltc.inverse_m_determinant":
        "test_torch_ltc.py::test_matrices_match_jax",
    "math.ltc.inverse_m_matrix": "test_torch_ltc.py::test_matrices_match_jax",
    "math.ltc.lambert_ltc_coefficients":
        "test_torch_ltc.py::test_identity_and_lambert",
    "math.ltc.m_matrix": "test_torch_ltc.py::test_identity_and_lambert",
    "math.ltc.oren_nayar_ltc_coefficients":
        "test_torch_ltc.py::test_oren_nayar_fit_matches_jax",
    "math.ltc.pdf": "test_torch_ltc.py::test_identity_and_lambert",
    "math.ltc.sample": "test_torch_ltc.py::test_sample_matches_jax",
    "math.morton.morton_decode_2d":
        "test_torch_bvh.py::test_morton_codes_are_bit_exact",
    "math.morton.morton_encode_2d":
        "test_torch_bvh.py::test_morton_codes_are_bit_exact",
    "math.morton.morton_encode_3d":
        "test_torch_bvh.py::test_morton_codes_are_bit_exact",
    "math.nelder_mead.nelder_mead":
        "test_torch_aux_modules.py::test_nelder_mead_matches_jax",
    "math.octahedral.octahedral_decode":
        "test_torch_lights.py::test_octahedral_encode_decode",
    "math.octahedral.octahedral_encode":
        "test_torch_lights.py::test_octahedral_encode_decode",
    "math.quaternion.quat_from_axis_angle":
        "test_torch_lights.py::test_tangent_frames_and_quaternions",
    "math.quaternion.quat_from_matrix":
        "test_torch_lights.py::test_tangent_frames_and_quaternions",
    "math.quaternion.quat_identity":
        "test_torch_public_functions.py::test_identities_equal_jax",
    "math.quaternion.quat_mul":
        "test_torch_public_functions.py::test_quat_mul_anchored",
    "math.quaternion.quat_rotate":
        "test_torch_lights.py::test_tangent_frames_and_quaternions",
    "math.quaternion.quat_to_matrix":
        "test_torch_lights.py::test_tangent_frames_and_quaternions",
    "math.ray_offset.offset_ray_origin":
        "test_torch_lights.py::test_offset_ray_origin_exact",
    "math.statistics.Statistics":
        "test_torch_aux_modules.py::test_statistics_match_jax",
    "math.transform.Transform":
        "test_torch_public_functions.py::"
        "test_transform_compose_and_delta_anchored",
    "math.transform.transform_compose":
        "test_torch_public_functions.py::"
        "test_transform_compose_and_delta_anchored",
    "math.transform.transform_delta":
        "test_torch_public_functions.py::"
        "test_transform_compose_and_delta_anchored",
    "math.transform.transform_identity":
        "test_torch_compositor.py::test_datamodel_textures_flow_into_render",
    "math.vec.cross":
        "test_torch_child_walk.py::test_both_walks_visit_the_same_nodes",
    "math.vec.distance":
        "test_torch_public_functions.py::test_vec3_and_distance",
    "math.vec.dot":
        "test_torch_child_walk.py::test_both_walks_visit_the_same_nodes",
    "math.vec.refract":
        "test_torch_transmissive.py::test_refract_and_dielectric_fresnel",
    "math.vec.to_local":
        "test_torch_lights.py::test_tangent_frames_and_quaternions",
    "math.vec.to_world":
        "test_torch_lights.py::test_tangent_frames_and_quaternions",
    "math.vec.vec3": "test_torch_public_functions.py::test_vec3_and_distance",
    "parallel.distributed.gather_rows":
        "test_torch_distributed.py::test_global_rows_round_trip",
    "parallel.distributed.global_render_mesh":
        "test_torch_distributed.py::test_global_rows_round_trip",
    "parallel.distributed.is_initialized":
        "test_torch_distributed.py::test_multihost_smallpt_at_world_size_one",
    "parallel.distributed.make_global_rows":
        "test_torch_distributed.py::test_global_rows_round_trip",
    "parallel.distributed.make_multihost_render":
        "test_torch_distributed.py::test_multihost_render_at_world_size_one",
    "parallel.distributed.make_multihost_smallpt":
        "test_torch_distributed.py::test_multihost_smallpt_at_world_size_one",
    "parallel.distributed.process_count":
        "test_torch_distributed.py::test_shard_rows_local",
    "parallel.distributed.process_index":
        "test_torch_distributed.py::test_shard_rows_local",
    "parallel.distributed.run_selftest":
        "test_torch_distributed.py::test_two_process_gloo_selftest",
    "parallel.distributed.shard_rows_local":
        "test_torch_distributed.py::test_shard_rows_local",
    "parallel.mesh.pad_to_multiple":
        "test_torch_parallel.py::test_mesh_and_shardings",
    "parallel.mesh.render_mesh":
        "test_torch_parallel_train.py::test_sharded_gradient_equals_unsharded",
    "parallel.mesh.replicated_sharding":
        "test_torch_parallel.py::test_mesh_and_shardings",
    "parallel.mesh.tile_sharding":
        "test_torch_parallel.py::test_mesh_and_shardings",
    "parallel.render.make_sharded_geometry_train_step":
        "test_torch_parallel_geometry.py::test_geometry_step_matches_jax",
    "parallel.render.make_sharded_render":
        "test_torch_parallel.py::test_sharded_render_matches_jax",
    "parallel.render.make_sharded_smallpt":
        "test_torch_parallel.py::test_sharded_smallpt",
    "parallel.render.make_sharded_train_step":
        "test_torch_parallel_train.py::test_sharded_gradient_equals_unsharded",
    "parallel.render.render_smallpt_sharded":
        "test_torch_parallel.py::"
        "test_render_smallpt_sharded_is_the_progressive_render",
    "parallel.render.silhouette_translation_boundary_grad":
        "test_torch_parallel_geometry.py::test_boundary_term_matches_jax",
    "post.bloom.dual_kawase_bloom":
        "test_torch_post_stateful.py::test_dual_kawase_bloom",
    "post.bloom.gaussian_bloom": "test_torch_post.py::test_gaussian_bloom",
    "post.exposure.eye_adaptation":
        "test_torch_post_stateful.py::test_eye_adaptation",
    "post.exposure.fixed_exposure": "test_torch_post.py::test_exposures",
    "post.exposure.histogram_exposure": "test_torch_post.py::test_exposures",
    "post.exposure.log_average_exposure": "test_torch_post.py::test_exposures",
    "post.exposure.luminance_histogram": "test_torch_post.py::test_exposures",
    "post.pipeline.process":
        "test_torch_megakernel_extras.py::test_viewer_renders_the_new_scenes",
    "post.pipeline.process_stateful":
        "test_torch_post_stateful.py::test_process_stateful_three_frames",
    "post.tonemap.CameraEffectsSettings":
        "test_torch_megakernel_extras.py::test_viewer_renders_the_new_scenes",
    "post.tonemap.TonemappingSettings":
        "test_torch_post.py::test_filmic_settings_within_1e5",
    "post.tonemap.agx": "test_torch_post.py::test_tonemap_operators",
    "post.tonemap.filmic":
        "test_torch_post.py::test_filmic_settings_within_1e5",
    "post.tonemap.khronos_neutral":
        "test_torch_post.py::test_tonemap_operators",
    "post.tonemap.reinhard":
        "test_torch_public_functions.py::test_reinhard_anchored",
    "preview.ibl.convolve_environment":
        "test_torch_preview.py::test_convolve_environment_levels",
    "preview.ibl.sample_ibl":
        "test_torch_preview.py::test_sample_ibl_matches_jax",
    "preview.renderer.PreviewBackend":
        "test_torch_preview.py::test_preview_backend",
    "preview.renderer.render_preview":
        "test_torch_preview.py::test_render_preview_matches_jax",
    "preview.ssao.bilateral_blur":
        "test_torch_preview.py::test_bilateral_blur_matches_jax",
    "preview.ssao.ssao": "test_torch_preview.py::test_ssao_matches_jax",
    "sampling.distributions.concentric_disk_sample":
        "test_torch_sampling.py::test_disk_cone_hemisphere_samplers",
    "sampling.distributions.cone_sample":
        "test_torch_sampling.py::test_disk_cone_hemisphere_samplers",
    "sampling.distributions.cosine_hemisphere_sample":
        "test_torch_sampling.py::test_disk_cone_hemisphere_samplers",
    "sampling.distributions.exponential_distance_sample":
        "test_torch_public_functions.py::"
        "test_exponential_distance_sample_anchored",
    "sampling.distributions.ggx_bounded_vndf_pdf":
        "test_torch_sampling.py::test_ggx_distributions",
    "sampling.distributions.ggx_bounded_vndf_sample":
        "test_torch_sampling.py::test_ggx_distributions",
    "sampling.distributions.ggx_ndf":
        "test_torch_sampling.py::test_ggx_distributions",
    "sampling.distributions.ggx_ndf_pdf":
        "test_torch_public_functions.py::test_ggx_ndf_sample_and_pdf_anchored",
    "sampling.distributions.ggx_ndf_sample":
        "test_torch_public_functions.py::test_ggx_ndf_sample_and_pdf_anchored",
    "sampling.distributions.ggx_vndf_pdf":
        "test_torch_transmissive.py::test_vndf",
    "sampling.distributions.ggx_vndf_sample":
        "test_torch_transmissive.py::test_vndf",
    "sampling.distributions.ggx_vndf_sample_halfway":
        "test_torch_transmissive.py::test_vndf",
    "sampling.distributions.oren_nayar_cltc_pdf":
        "test_torch_sampling.py::test_oren_nayar_cltc",
    "sampling.distributions.oren_nayar_cltc_sample":
        "test_torch_sampling.py::test_oren_nayar_cltc",
    "sampling.distributions.uniform_hemisphere_sample":
        "test_torch_sampling.py::test_disk_cone_hemisphere_samplers",
    "sampling.distributions.uniform_sphere_sample":
        "test_torch_public_functions.py::test_uniform_sphere_sample_anchored",
    "sampling.hashes.cessen_owen_hash":
        "test_torch_sampling.py::test_cessen_owen_hash_bit_exact",
    "sampling.hashes.jenkins_hash":
        "test_torch_smallpt.py::test_jenkins_hash_is_bit_exact",
    "sampling.hashes.laine_karras_hash":
        "test_torch_public_functions.py::test_hashes_bit_exact",
    "sampling.hashes.lcg_next":
        "test_torch_smallpt.py::test_lcg_next_is_bit_exact",
    "sampling.hashes.pcg2d": "test_torch_sampling.py::test_pcg2d_bit_exact",
    "sampling.hashes.reverse_bits":
        "test_torch_sampling.py::test_reverse_bits_bit_exact",
    "sampling.hashes.sobol2":
        "test_torch_public_functions.py::test_hashes_bit_exact",
    "sampling.hashes.teschner_hash":
        "test_torch_public_functions.py::test_hashes_bit_exact",
    "sampling.hashes.uint_to_unit_float":
        "test_torch_sampling.py::test_uint_to_unit_float_exact",
    "sampling.hashes.van_der_corput":
        "test_torch_fittings_precompute.py::test_shared_samples_match_jax",
    "sampling.pmj.pmj02_bn_samples":
        "test_torch_environment.py::test_pmj02_bn_samples_exact",
    "sampling.sobol.path_rng_4d":
        "test_torch_sampling.py::test_path_rng_4d_bit_exact",
    "sampling.sobol.sobol_sample_4d_uint":
        "test_torch_sampling.py::test_sobol_bit_exact_vs_jax",
    "scene.camera.camera_ray_directions":
        "test_torch_lights.py::test_camera_rays",
    "scene.camera.orthographic_projection":
        "test_torch_public_functions.py::"
        "test_orthographic_projection_equals_jax",
    "scene.camera.perspective_camera":
        "test_torch_datamodel.py::test_refit_matches_full_rebuild_render",
    "scene.datamodel.SceneData":
        "test_torch_datamodel.py::test_render_scene_equals_jax",
    "scene.datamodel.SceneSync":
        "test_torch_datamodel.py::test_megakernel_tables_follow_the_sync",
    "scene.materials.MaterialArray":
        "test_torch_bvh.py::test_refit_render_scene_follows_a_moved_instance",
    "scene.materials.coated_dielectric":
        "test_torch_public_functions.py::test_material_presets_equal_jax",
    "scene.materials.dielectric":
        "test_torch_bvh.py::test_refit_render_scene_follows_a_moved_instance",
    "scene.materials.emissive":
        "test_torch_public_functions.py::test_material_presets_equal_jax",
    "scene.materials.metal":
        "test_torch_megakernel.py::test_packed_tables_match_jax",
    "scene.materials.transmissive":
        "test_torch_megakernel.py::test_ineligibility_reasons_cover_jax",
    "scene.render_scene.RenderScene":
        "test_torch_datamodel.py::test_render_scene_equals_jax",
    "scene.render_scene.build_render_scene":
        "test_torch_bvh.py::test_refit_render_scene_follows_a_moved_instance",
    "scene.render_scene.refit_render_scene":
        "test_torch_bvh.py::test_refit_render_scene_follows_a_moved_instance",
    "scene.spheres.SphereScene":
        "test_torch_smallpt.py::test_intersect_spheres_reports_misses",
    "scene.spheres.intersect_spheres":
        "test_torch_smallpt.py::test_intersect_spheres_matches_jax",
    "scene.spheres.smallpt_scene":
        "test_torch_smallpt.py::"
        "test_intersect_spheres_matches_float64_reference",
    "scene.spheres.smallvpt_scene":
        "test_torch_smallpt.py::test_smallvpt_matches_jax",
    "shading.default_shading.DefaultShading":
        "test_torch_regularization.py::test_create_with_max_pdf_hint",
    "shading.fittings.Fittings":
        "test_torch_fittings_precompute.py::test_writes_where_asked_and_loads",
    "shading.fittings.encode_pdf":
        "test_torch_regularization.py::test_encode_pdf",
    "shading.fittings.estimate_ggx_alpha_from_max_pdf":
        "test_torch_regularization.py::test_estimate_ggx_alpha_from_max_pdf",
    "shading.fittings.get_fittings": "test_torch_bsdf.py::test_rho_lookups",
    "shading.fittings.precompute_fittings":
        "test_torch_fittings_precompute.py::test_writes_where_asked_and_loads",
    "shading.fittings.sample_burley_rho":
        "test_torch_transmissive.py::test_rho_lookups",
    "shading.fittings.sample_dielectric_ggx_rho":
        "test_torch_transmissive.py::test_rho_lookups",
    "shading.fittings.sample_ggx_rho": "test_torch_bsdf.py::test_rho_lookups",
    "shading.fittings.sample_ggx_with_fresnel_rho":
        "test_torch_bsdf.py::test_rho_lookups",
    "shading.ltc_fit.get_ggx_ltc_table":
        "test_torch_ltc.py::test_table_lookup_matches_jax",
    "shading.ltc_fit.ggx_reflection_ltc_coefficients":
        "test_torch_ltc.py::test_table_lookup_matches_jax",
    "shading.ltc_fit.precompute_ggx_ltc":
        "test_torch_ltc.py::test_precompute_reaches_jax_objective",
    "shading.thin_sheet.approx_thin_sheet_reflectance":
        "test_torch_transmissive.py::test_thin_sheet",
    "shading.thin_sheet.refracted_cos_theta":
        "test_torch_transmissive.py::test_thin_sheet",
    "shading.thin_sheet.smooth_thin_sheet_reflectance":
        "test_torch_transmissive.py::test_thin_sheet",
    "shading.transmissive_shading.TransmissiveShading":
        "test_torch_transmissive.py::test_transmissive_shading",
    "utils.checkpoint.latest_checkpoint":
        "test_torch_checkpoint.py::test_latest_checkpoint",
    "utils.checkpoint.load_checkpoint":
        "test_torch_checkpoint.py::test_jax_writes_port_loads",
    "utils.checkpoint.save_checkpoint":
        "test_torch_checkpoint.py::test_jax_writes_port_loads",
    "utils.hostbuild.host_build":
        "test_torch_aux_modules.py::test_host_build_on_the_cpu",
    "utils.profiling.FrameTimer":
        "test_torch_checkpoint.py::test_stage_timings_and_frame_timer",
    "utils.profiling.StageTimings":
        "test_torch_checkpoint.py::test_stage_timings_and_frame_timer",
    "utils.profiling.device_trace":
        "test_torch_checkpoint.py::test_device_trace_writes_a_chrome_trace",
}
