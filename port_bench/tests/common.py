"""A tiny copy of the cbox cell (24 x 20 pixels) for runs on the CPU."""
import json
import re
import shutil
from pathlib import Path

from port_bench import assets, harness

TINY = (24, 20)


# bunny.xml's generated meshes, cut to 1,480 triangles (still on the BVH
# tier), and its textures
TINY_BUNNY = [("torus_knot", f"meshes/cornell/{name}.obj",
               dict(n_u=n_u, n_v=n_v, R=R, r=r, tube=tube, offset=off))
              for name, n_u, n_v, R, r, tube, off in (
                  ("bunny_body", 30, 6, 0.3, 0.12, 0.06, (3.0, 0.5, 3.3)),
                  ("bunny_head", 20, 4, 0.15, 0.06, 0.035, (2.4, 0.3, 1.2)),
                  ("bunny_full1", 40, 6, 0.35, 0.12, 0.06, (1.6, 0.6, 2.6)),
                  ("bunny_full2", 40, 6, 0.35, 0.12, 0.06,
                   (3.3, 0.6, 1.9)))] \
    + [("marble_jpeg", f"meshes/textures/{name}", {})
       for name in ("crystal.jpg", "lava.jpeg", "mat.jpeg")]


def tiny_scene(tmp, name="cbox.xml"):
    """port_bench/scenes/cbox/<name> at 24 x 20 beside a copy of its
    meshes; bunny.xml's meshes are cut to 1,480 triangles (still on the BVH
    tier). Returns the XML."""
    src = harness.HERE / "scenes"
    shutil.copytree(src / "meshes", tmp / "meshes", dirs_exist_ok=True)
    (tmp / "cbox").mkdir(exist_ok=True)
    xml = (src / "cbox" / name).read_text()
    if name == "bunny.xml":
        xml = xml.replace("./port_bench/scenes/meshes/",
                          f"{tmp / 'meshes'}/")
        assets.ensure(tmp, [{"maker": m, "path": p, "args": a}
                            for m, p, a in TINY_BUNNY])
    xml = re.sub(r'name="width" value="\d+"', f'name="width" value="{TINY[0]}"',
                 xml)
    xml = re.sub(r'name="height" value="\d+"',
                 f'name="height" value="{TINY[1]}"', xml)
    (tmp / "cbox" / name).write_text(xml)
    return tmp / "cbox" / name


def tiny_bench(tmp):
    """(bench, base): BENCHMARK.json with the cbox configuration's scene
    swapped for the tiny one, and a data directory copied from
    port_bench's."""
    base = tmp / "data"
    for sub in ("traffic", "drivers", "limits", "metrics"):
        shutil.copytree(harness.HERE / sub, base / sub)
    bench = harness.manifest()
    conf = json.loads((harness.ROOT / "port_bench/configs/cbox.json")
                      .read_text())
    conf["scene"] = str(tiny_scene(tmp))
    (base / "configs").mkdir()
    (base / "configs" / "cbox.json").write_text(json.dumps(conf))
    for c in bench["configs"]:
        c["file"] = str(base / "configs" / f"{c['name']}.json")
    return bench, base
