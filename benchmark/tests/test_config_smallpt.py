"""``configs/smallpt.json`` against the port's SmallPT scene and
estimator: the nine spheres tensor by tensor (``scene/spheres.
smallpt_scene``), and the camera, the path settings and the documented
departures from ``smallpt.h`` against ``integrator/smallpt.py``'s
constants."""

import os

import torch

from benchmark.harness import spec
from benchmark.reference import smallpt as ref

CONFIG = spec._json(os.path.join(spec.BENCH_DIR, "configs", "smallpt.json"))


def test_config_is_the_ports_smallpt_scene():
    from bifrost3d_tpu_torch.scene.spheres import (smallpt_scene,
                                                   sphere_scene_from_numpy)
    rows = CONFIG["spheres"]
    none = [0.0] * len(rows)
    got = sphere_scene_from_numpy(dict(
        radius=[r[0] for r in rows], position=[r[1] for r in rows],
        emission=[r[2] for r in rows], color=[r[3] for r in rows],
        bsdf=[r[4] for r in rows], medium_sigma_t=none, medium_albedo=none,
        medium_g=none), device="cpu")
    want = smallpt_scene(device=torch.device("cpu"))
    for name in want._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    # The reference reads the same rows.
    sph = ref.spheres(CONFIG, "cpu")
    for name in sph._fields:
        assert torch.equal(getattr(sph, name), getattr(want, name)), name


def test_config_holds_the_ports_camera_and_path_settings():
    from bifrost3d_tpu_torch.integrator import smallpt as port
    st = ref.settings(CONFIG)
    assert (st.max_depth, st.rr_start_depth) == (port.MAX_DEPTH,
                                                 port.RR_START_DEPTH)
    assert (st.eps, st.origin_offset) == (port.EPS, port.ORIGIN_OFFSET)
    assert CONFIG["departures"]["glass_rr_start_depth"] == \
        port.GLASS_RR_START_DEPTH
    assert st.cam_origin == port.SMALLPT_CAM_ORIGIN
    assert st.cam_direction == port.SMALLPT_CAM_DIRECTION
    w, h = CONFIG["width"], CONFIG["height"]
    for got, want in zip(ref.camera_frame(st, w, h, "cpu"),
                         port.camera_frame(w, h, "cpu")):
        assert torch.equal(got, want)
