"""The port's rendering (``ilqr_tpu_torch/viz``) and its apps, headless (Agg).

Sprites and the obstacle states equal ``ilqr_tpu``'s (numpy, the same
inputs); the frame, the demo-2 replay and the tracking console render;
the three demo apps and ``motion_planning`` run with ``--device cpu``,
headless (``--no-viz``) and saving their plots to ``tmp_path``.
"""

import os

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from ilqr_tpu.utils.refline import RoutingLine as JaxRoutingLine  # noqa: E402
from ilqr_tpu.utils.refline import get_cur_obstacle_states as jax_obstacle_states  # noqa: E402
from ilqr_tpu.viz import render as jax_render  # noqa: E402
from ilqr_tpu_torch.apps import cilqr_demo, lqr_demo, lqr_tracking, motion_planning  # noqa: E402
from ilqr_tpu_torch.utils.refline import RoutingLine, get_cur_obstacle_states  # noqa: E402
from ilqr_tpu_torch.viz import render  # noqa: E402

from tests.conftest import CONFIG_DIR  # noqa: E402
from tests.torch_parity import load_both  # noqa: E402

CFG = os.path.join(CONFIG_DIR, "scenario_two_straight.yaml")


def test_sprites_match_jax(tmp_path):
    path = tmp_path / "s.mat.txt"
    data = np.arange(2 * 3 * 4, dtype=np.float32).reshape(2, 3, 4) / 24.0
    with open(path, "w") as f:
        f.write("Convert from PNG\n2 3 4\n")
        for row in data.reshape(-1, 4):
            f.write(" ".join(str(v) for v in row) + "\n")
    np.testing.assert_array_equal(render.imread_mat(str(path)), jax_render.imread_mat(str(path)))
    bad = tmp_path / "bad.txt"
    bad.write_text("nope\n")
    with pytest.raises(ValueError):
        render.imread_mat(str(bad))
    np.testing.assert_array_equal(render.make_car_sprite(), jax_render.make_car_sprite())
    np.testing.assert_array_equal(render._steering_wheel_sprite(),
                                  jax_render._steering_wheel_sprite())


def test_get_cur_obstacle_states_matches_jax(rng):
    lines = [rng.normal(size=(3, 5)) for _ in range(3)]
    got = get_cur_obstacle_states([RoutingLine(*a) for a in lines], 2)
    want = jax_obstacle_states([JaxRoutingLine(*a) for a in lines], 2)
    assert got.shape == (2, 3)
    np.testing.assert_array_equal(got, want)
    assert get_cur_obstacle_states([RoutingLine(*lines[0])], 0).shape == (0, 3)
    with pytest.raises(IndexError):
        RoutingLine(*lines[0])[5]


def test_render_frame_smoke():
    _, _, _, st = load_both("scenario_two_straight")
    fig, ax = plt.subplots()
    planned = np.tile(np.asarray([1.0, 0.0, 8.0, 0.0]), (31, 1))
    planned[:, 0] += np.arange(31) * 0.8
    render.render_frame(ax, st, st.ego_x0, planned, np.asarray([0.5, 0.01]), tick=0,
                        show_obstacle_boundary=True, show_reference_line=True)
    assert len(ax.images) >= 2  # car sprites + steering wheel
    plt.close(fig)


def test_animate_demo_replay_and_console_smoke(tmp_path):
    N = 6
    x = np.zeros((N + 1, 4))
    x[:, 0] = np.arange(N + 1) * 0.5
    x[:, 2] = 5.0
    u = np.tile(np.asarray([0.5, -0.02]), (N, 1))
    obs = np.zeros((2, N + 1, 4))
    obs[0, :, 0] = 6.5 + 0.3 * np.arange(N + 1)
    obs[1, :, :2] = (20.0, 4.0)
    out = tmp_path / "demo.gif"
    fig = render.animate_demo_replay(u, x, obs, length=4.5, width=2.0, acc_max=2.0,
                                     out_path=str(out))
    assert out.stat().st_size > 0
    plt.close(fig)
    fig, ax = plt.subplots()
    render.plot_wire_car(ax, 3.0, 1.0, 0.4, steer=0.3)
    assert len(ax.lines) == 8  # outline + 4 wheels + 3 arrow segments
    render.plot_tracking_console(ax, steer=0.2, acc=-1.5, acc_max=5.0)
    assert len(ax.images) == 1 and len(ax.patches) >= 2
    plt.close(fig)


@pytest.mark.parametrize("viz", ["no_viz", "save"])
def test_demo_apps_on_cpu(viz, tmp_path, capsys):
    def args(name):
        return ["--no-viz"] if viz == "no_viz" else ["--save", str(tmp_path / name)]

    assert lqr_demo.main(["--device", "cpu", "--steps", "20", *args("lqr.png")]) == 0
    assert lqr_tracking.main(["--device", "cpu", *args("track.png")]) == 0
    out = capsys.readouterr().out
    assert "Pstar =" in out and "Kstar =" in out
    assert "goal reached after 255 ticks" in out
    assert cilqr_demo.main(["--device", "cpu", "--max-iter", "2", "--batch", "2",
                            *args("demo.gif")]) == 0
    assert motion_planning.main(["-c", CFG, "--ticks", "2", "--device", "cpu",
                                 *args("mp.gif")]) == 0
    plt.close("all")
    if viz == "save":
        for name in ("lqr_open.png", "lqr_closed.png", "track.png", "demo.gif", "mp.gif"):
            assert (tmp_path / name).stat().st_size > 0, name


def test_apps_need_a_card_by_default():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    for main in (lqr_demo.main, lqr_tracking.main, cilqr_demo.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["--no-viz"])
