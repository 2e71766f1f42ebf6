"""Host-clock seconds of the program's scene build in set-up
(``scene/render_scene.build_render_scene``: the soup, the BVH, the
packings), ending in a synchronise."""


def read(reading):
    return reading.get("scene_build_s")
