"""The port's ambisonics toolbox against the JAX package's: encoder,
rotations, t-designs, the CIPIC HRIR loader, the embedded binaural filters,
every binauralizer, and the three CLIs (sag-torch-encode,
sag-torch-binauralize, sag-torch-encode-and-binauralize).

The port's modules are numpy/scipy copies of the JAX package's, so every
array is held bit for bit, and every wav the CLIs write byte for byte, on
the scene of tests/test_cli_tools.py (a 2 s source at 8 kHz swept from
+90 to -90 degrees azimuth). The one change in the port is the CIPIC
nearest-direction search (an exhaustive numpy search where the JAX package
queries scikit-learn's KDTree): it must pick the same grid entry.
CIPIC directories are written in the test, in the layout of
tests/test_hrir.py; make_tdesign's optimisation (about 30 s) is left out,
and the tabulated designs (orders 1 and 2) are compared.
"""

import numpy as np
import pytest

import spatialaudiogen_tpu.ambisonics as jax_ambi
import spatialaudiogen_tpu_torch.ambisonics as port_ambi
from spatialaudiogen_tpu.ambisonics import binaural_filters as jax_bf
from spatialaudiogen_tpu.ambisonics import binauralizer as jax_bin
from spatialaudiogen_tpu.ambisonics import hrir as jax_hrir
from spatialaudiogen_tpu.ambisonics import tdesigns as jax_td
from spatialaudiogen_tpu.cli import binauralize as jax_binauralize_cli
from spatialaudiogen_tpu.cli import encode as jax_encode_cli
from spatialaudiogen_tpu.cli import encode_and_binauralize as jax_enc_bin_cli
from spatialaudiogen_tpu_torch.ambisonics import binaural_filters as bf
from spatialaudiogen_tpu_torch.ambisonics import binauralizer as port_bin
from spatialaudiogen_tpu_torch.ambisonics import hrir as port_hrir
from spatialaudiogen_tpu_torch.ambisonics import rotation as port_rotation
from spatialaudiogen_tpu_torch.ambisonics import tdesigns as td
from spatialaudiogen_tpu_torch.cli import binauralize as binauralize_cli
from spatialaudiogen_tpu_torch.cli import encode as encode_cli
from spatialaudiogen_tpu_torch.cli import encode_and_binauralize as enc_bin_cli
from spatialaudiogen_tpu_torch.utils.io_audio import save_wav

RATE = 8000
CIPIC_RATE = 44100


def both(module_name: str):
    """(JAX class or function, port one) of the same name in ambisonics."""
    return getattr(jax_ambi, module_name), getattr(port_ambi, module_name)


def sources(pkg, rng_seed: int = 0):
    """Two static sources and one moving source of `pkg`'s classes."""
    rng = np.random.RandomState(rng_seed)
    sig = rng.randn(3, 4000)
    static = [pkg.PositionalSource(sig[0], pkg.Position(0.3, 1.2, 0.4, "cartesian"), RATE),
              pkg.PositionalSource(sig[1], pkg.Position(-2.0, 0.5, 1.5, "polar"), RATE)]
    moving = pkg.MovingSource(sig[2], [pkg.Position(1.5, 0.0, 1.0, "polar"),
                                       pkg.Position(-1.5, 0.3, 1.0, "polar"),
                                       pkg.Position(0.2, -0.4, 2.0, "polar")], RATE)
    return static, moving


@pytest.fixture(scope="module")
def cipic_dir(tmp_path_factory):
    """A CIPIC-layout directory (per-azimuth wavs, one column per elevation)
    of seeded random 200-tap responses."""
    d = tmp_path_factory.mktemp("cipic")
    rng = np.random.RandomState(3)
    for az in jax_hrir.CIPIC_AZIMUTHS:
        stem = ("neg" if az < 0 else "") + str(abs(az))
        for ear in ("left", "right"):
            data = (0.1 * rng.randn(200, len(jax_hrir.CIPIC_ELEVATIONS))).astype(np.float32)
            save_wav(str(d / f"{stem}az{ear}.wav"), data, CIPIC_RATE, subtype="float32")
    return str(d)


@pytest.fixture
def scene(tmp_path):
    """The scene of tests/test_cli_tools.py."""
    t = np.arange(RATE * 2) / RATE
    save_wav(str(tmp_path / "src.wav"), 0.5 * np.sin(2 * np.pi * 440 * t), RATE)
    (tmp_path / "scene-position.txt").write_text(
        "s1 src.wav 0.0 0.0 1.0\n"
        "s1 -1.5707 0.0 1.0\n"
        "s1 1.5707 0.0 1.0\n")
    return tmp_path


@pytest.mark.parametrize("order", [1, 2, 3])
def test_encoder_matches_jax(order):
    outs = []
    for pkg in (jax_ambi, port_ambi):
        static, moving = sources(pkg)
        enc = pkg.AmbiEncoder(pkg.AmbiFormat(order=order, sample_rate=RATE))
        frames = pkg.AmbisonicArray(np.zeros((4000, (order + 1) ** 2)),
                                    pkg.AmbiFormat(order=order, sample_rate=RATE))
        for i in range(0, 4000, 997):
            enc.encode_frame(static, frames, i)
        outs.append([enc.encode(static).data, enc.encode(static + [moving]).data,
                     enc.encode_moving(moving).data, enc.encode_with_distance(static).data,
                     frames.data])
    for got, want in zip(outs[1], outs[0]):
        assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("rotation", [-np.pi, -1.0, 0.0, 0.7, 3.0])
def test_foa_rotation_matches_jax(rotation):
    chunk = np.random.RandomState(1).randn(50, 4).astype(np.float32)
    jax_rot, port_rot = both("foa_rotation_matrix")
    assert np.array_equal(port_rot(rotation), jax_rot(rotation))
    jax_apply, port_apply = both("rotate_foa")
    got, want = port_apply(chunk, rotation), jax_apply(chunk, rotation)
    assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
    assert np.array_equal(port_rotation.sh_rotation_z(1, rotation), jax_rot(rotation))


@pytest.mark.parametrize("order,n", [(1, None), (1, 4), (1, 6), (1, 8), (1, 12), (2, None),
                                     (2, 20)])
def test_tdesigns_match_jax(order, n):
    got, want = td.get_tdesign(order, n), jax_td.get_tdesign(order, n)
    assert np.array_equal(got, want)
    assert td.design_residual(got, order) == jax_td.design_residual(want, order) < 1e-12


def test_cipic_hrir_matches_jax(cipic_dir):
    port, ref = port_hrir.CipicHRIR(cipic_dir), jax_hrir.CipicHRIR(cipic_dir)
    assert np.array_equal(port.left_hrir, ref.left_hrir)
    assert np.array_equal(port.right_hrir, ref.right_hrir)
    rng = np.random.RandomState(4)
    for _ in range(300):
        x, y, z = rng.randn(3) * rng.uniform(0.2, 5.0)
        got = port.get_closest(port_ambi.Position(x, y, z, "cartesian"))
        want = ref.get_closest(jax_ambi.Position(x, y, z, "cartesian"))
        assert np.array_equal(got[0].coords("cartesian"), want[0].coords("cartesian"))
        assert np.array_equal(got[1], want[1]) and np.array_equal(got[2], want[2])


@pytest.mark.parametrize("order", [1, 2])
def test_binaural_filters_match_jax(order):
    for direction in ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.3, -0.8, 0.5)):
        got, want = bf.spherical_head_hrir(direction, RATE), \
            jax_bf.spherical_head_hrir(direction, RATE)
        assert all(np.array_equal(g, w) for g, w in zip(got, want)) and len(got) == 2
    got = bf.make_binaural_decoder_filters(order, RATE)
    want = jax_bf.make_binaural_decoder_filters(order, RATE)
    assert all(np.array_equal(g, w) for g, w in zip(got, want))
    ambi = np.random.RandomState(order).randn(3000, (order + 1) ** 2)
    assert np.array_equal(
        bf.AmbisonicFilterBinauralizer(port_ambi.AmbiFormat(order, sample_rate=RATE))
        .binauralize(ambi),
        jax_bf.AmbisonicFilterBinauralizer(jax_ambi.AmbiFormat(order, sample_rate=RATE))
        .binauralize(ambi))


@pytest.mark.parametrize("method", ["stereo_mic", "convolvotron"])
def test_source_binauralizers_match_jax(cipic_dir, method):
    outs = []
    for pkg, module in ((jax_ambi, jax_bin), (port_ambi, port_bin)):
        static, moving = sources(pkg, rng_seed=5)
        use_hrtfs = method == "convolvotron"
        binaur = module.SourceBinauralizer(use_hrtfs=use_hrtfs,
                                           cipic_dir=cipic_dir if use_hrtfs else None)
        frames = np.zeros((4000, 2))
        for i in list(range(0, 400)) + list(range(3900, 4000)):
            binaur.binauralize_frame(static, frames, i)
        outs.append([binaur.binauralize(static), binaur.binauralize(static[0]), frames])
    for got, want in zip(outs[1], outs[0]):
        assert np.array_equal(got, want)


@pytest.mark.parametrize("method,hrtfs", [("projection", None), ("pseudoinv", None),
                                          ("projection", "embedded"), ("pseudoinv", "cipic"),
                                          ("direct", None)])
def test_ambisonic_binauralizers_match_jax(cipic_dir, method, hrtfs):
    order = 1
    ambi = np.random.RandomState(6).randn(2000, 4)
    outs = []
    for pkg, module in ((jax_ambi, jax_bin), (port_ambi, port_bin)):
        fmt = pkg.AmbiFormat(order=order, sample_rate=CIPIC_RATE if hrtfs == "cipic" else RATE)
        if method == "direct":
            binaur = module.DirectAmbisonicBinauralizer(fmt, method="pseudoinv")
        else:
            binaur = module.AmbisonicBinauralizer(
                fmt, method=method, use_hrtfs=hrtfs is not None,
                cipic_dir=cipic_dir if hrtfs == "cipic" else None)
        outs.append(binaur.binauralize(ambi))
    assert outs[1].shape == outs[0].shape and outs[1].shape[1] == 2
    assert np.array_equal(outs[1], outs[0])


def cli_outputs(main, argv: list, out_files: list) -> list:
    main(argv)
    return [open(fn, "rb").read() for fn in out_files]


@pytest.mark.parametrize("case", ["position_file", "xyz", "order2"])
def test_encode_cli_matches_jax(scene, case):
    argv = {"position_file": [str(scene / "scene-position.txt"), "{out}", "--rate", str(RATE)],
            "xyz": [str(scene / "src.wav"), "{out}", "--xyz", "0", "1", "0"],
            "order2": [str(scene / "scene-position.txt"), "{out}", "--rate", str(RATE),
                       "--ambi_order", "2"]}[case]
    got, want = (cli_outputs(main, [a.format(out=scene / f"{who}.wav") for a in argv],
                             [scene / f"{who}.wav"])
                 for who, main in (("port", encode_cli.main), ("jax", jax_encode_cli.main)))
    assert got == want and len(got[0]) > 44


@pytest.mark.parametrize("flags", [[], ["--method", "pseudoinv"], ["--method", "direct"],
                                   ["--use_hrtfs"], ["--position_fn"], ["--xyz"],
                                   ["--use_hrtfs", "--cipic_dir"]])
def test_binauralize_cli_matches_jax(scene, cipic_dir, flags):
    ambix = str(scene / "ambix.wav")
    jax_encode_cli.main([str(scene / "scene-position.txt"), ambix, "--rate", str(RATE)])
    if flags == ["--position_fn"]:
        base = [str(scene / "src.wav"), "{out}", "--position_fn",
                str(scene / "scene-position.txt")]
    elif flags == ["--xyz"]:
        base = [str(scene / "src.wav"), "{out}", "--xyz", "0.5", "1.0", "0.2"]
    elif "--cipic_dir" in flags:
        base = [ambix, "{out}", "--use_hrtfs", "--cipic_dir", cipic_dir]
    else:
        base = [ambix, "{out}", *flags]
    got, want = (cli_outputs(main, [a.format(out=scene / f"{who}.wav") for a in base],
                             [scene / f"{who}.wav"])
                 for who, main in (("port", binauralize_cli.main),
                                   ("jax", jax_binauralize_cli.main)))
    assert got == want and len(got[0]) > 44


@pytest.mark.parametrize("flags", [[], ["--method", "pseudoinv"], ["--method", "direct"],
                                   ["--xyz", "0", "1", "0"]])
def test_encode_and_binauralize_cli_matches_jax(scene, flags):
    first = str(scene / ("src.wav" if "--xyz" in flags else "scene-position.txt"))
    rate = [] if "--xyz" in flags else ["--rate", str(RATE)]
    outs = []
    for who, main in (("port", enc_bin_cli.main), ("jax", jax_enc_bin_cli.main)):
        prefix = str(scene / who)
        outs.append(cli_outputs(main, [first, prefix, *rate, *flags],
                                [prefix + "-ambix.wav", prefix + "-stereo.wav"]))
    assert outs[0] == outs[1]


def test_source_at_plus_90_degrees_is_louder_left(scene):
    """cli.encode --xyz 0 1 0 (y is left) then cli.binauralize --use_hrtfs
    (the embedded filters): the left ear carries more energy, as phase 18
    of chip_smoke.py checks on the card's host."""
    from spatialaudiogen_tpu_torch.utils.io_audio import load_wav

    encode_cli.main([str(scene / "src.wav"), str(scene / "a.wav"), "--xyz", "0", "1", "0"])
    binauralize_cli.main([str(scene / "a.wav"), str(scene / "st.wav"), "--use_hrtfs"])
    stereo, rate = load_wav(str(scene / "st.wav"))
    assert rate == RATE and stereo.shape == (2 * RATE, 2)
    left, right = (stereo ** 2).sum(axis=0)
    assert left > right
