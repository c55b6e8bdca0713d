"""Image input/output and colour management.

Replaces the reference's OpenImageIO edge (read_image_data
envutil_basic.h:823-986, save_array envutil_basic.h:710-817): EXR goes
through the native C++ shim (io/native/envio.cc, OpenEXR scanline
files with Projection/Hfov metadata, built with ``make`` at first use
where OpenEXR's headers are installed), PFM through a reader and writer
in numpy that need no library, LDR formats (png/jpg/...) through
imageio. All rendering arithmetic is float32 scene-linear RGB, like the
reference; sRGB<->linear conversion is built in (environment.h:524-533,
envutil_payload.cc:225-235), other colour spaces can be plugged in via
PyOpenColorIO if available.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import pathlib
import subprocess
from typing import Optional

import numpy as np

from ..core.conventions import FACE_NAMES

_NATIVE_DIR = pathlib.Path(__file__).parent / "native"
_LIB = None


def _load_native():
    global _LIB
    if _LIB is not None:
        return _LIB
    so = _NATIVE_DIR / "libenvio.so"
    # built at first use; the lock keeps concurrent processes (parallel
    # test workers) from loading a library another one is still linking
    with open(_NATIVE_DIR / ".build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not so.exists():
            subprocess.run(["make", "-C", str(_NATIVE_DIR)], check=True,
                           capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.envio_read_exr.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int)]
    lib.envio_read_exr.restype = ctypes.c_int
    lib.envio_read_exr_header.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
    lib.envio_read_exr_header.restype = ctypes.c_int
    lib.envio_read_exr_string_attr.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_char_p)]
    lib.envio_read_exr_string_attr.restype = ctypes.c_int
    lib.envio_read_exr_float_attr.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.POINTER(ctypes.c_float)]
    lib.envio_read_exr_float_attr.restype = ctypes.c_int
    lib.envio_write_exr.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float), ctypes.c_int,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int]
    lib.envio_write_exr.restype = ctypes.c_int
    lib.envio_free.argtypes = [ctypes.c_void_p]
    _LIB = lib
    return lib


# ---------------------------------------------------------------------------
# colour management
# ---------------------------------------------------------------------------

LINEAR_NAMES = {"", "linear", "Linear", "scene_linear", "lin_rec709"}
SRGB_NAMES = {"sRGB", "srgb"}


def srgb_to_linear(v: np.ndarray) -> np.ndarray:
    """sRGB EOTF (environment.h:524-533)."""
    v = np.asarray(v, np.float32)
    return np.where(v <= 0.04045, v / 12.92,
                    ((v + 0.055) / 1.055) ** 2.4).astype(np.float32)


def linear_to_srgb(v: np.ndarray) -> np.ndarray:
    """inverse EOTF (envutil_payload.cc:225-235)."""
    v = np.asarray(v, np.float32)
    return np.where(v <= 0.0031308, 12.92 * v,
                    1.055 * np.clip(v, 0, None) ** (1.0 / 2.4) - 0.055
                    ).astype(np.float32)


def convert_colour(arr: np.ndarray, src: str, dst: str,
                   alpha_channels: bool = True) -> np.ndarray:
    """Convert between colour spaces. Linear<->sRGB is built in; other
    pairs require PyOpenColorIO. Alpha channels (last channel of 2- or
    4-channel data) are passed through untouched."""
    if src == dst or (src in LINEAR_NAMES and dst in LINEAR_NAMES):
        return arr
    nch = arr.shape[-1]
    has_alpha = alpha_channels and nch in (2, 4)
    colour = arr[..., :nch - 1] if has_alpha else arr

    # an active $OCIO config takes precedence, like OIIO's
    # colorconvert (envutil_main.cc:396-437); io/ocio.py implements
    # the algebraic transform subset without PyOpenColorIO
    ocio_out = None
    import os as _os
    if _os.environ.get("OCIO") and colour.shape[-1] == 3:
        from . import ocio as _ocio
        ocio_out = _ocio.convert(colour, src, dst)
    if ocio_out is not None:
        out = ocio_out
    elif src in SRGB_NAMES and dst in LINEAR_NAMES:
        out = srgb_to_linear(colour)
    elif src in LINEAR_NAMES and dst in SRGB_NAMES:
        out = linear_to_srgb(colour)
    else:
        from . import colour as C
        if C.known(src) and C.known(dst) and colour.shape[-1] == 3:
            # built-in spaces (primaries + transfer, io/colour.py)
            out = C.convert(colour, src, dst)
        else:
            # anything else needs a full OCIO config
            try:
                import PyOpenColorIO as ocio  # noqa: F401
            except ImportError:
                raise ValueError(
                    f"colour conversion {src!r} -> {dst!r} is not "
                    "built in and needs an OCIO config "
                    "(PyOpenColorIO not available)") from None
            config = ocio.GetCurrentConfig()
            proc = config.getProcessor(src, dst).getDefaultCPUProcessor()
            out = np.ascontiguousarray(colour, np.float32)
            proc.applyRGB(out)
    if has_alpha:
        out = np.concatenate([out, arr[..., -1:]], axis=-1)
    return out


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def _is_exr(path: str) -> bool:
    return str(path).lower().endswith(".exr")


def _is_pfm(path: str) -> bool:
    return str(path).lower().endswith(".pfm")


def _read_pfm_header(f):
    """Parse a PFM header from an open binary file: returns (width,
    height, channels, byte order); the file is left at the pixels."""
    tag = f.readline().strip()
    if tag not in (b"PF", b"Pf"):
        raise IOError(f"not a PFM file (tag {tag!r})")
    dims = f.readline().split()
    scale = float(f.readline())
    return (int(dims[0]), int(dims[1]), 3 if tag == b"PF" else 1,
            "<" if scale < 0 else ">")


def read_pfm(path: str) -> np.ndarray:
    """Read a PFM file (float32, 1 or 3 channels, rows stored bottom
    to top) to a top-down (H, W, C) float32 array."""
    with open(path, "rb") as f:
        w, h, c, order = _read_pfm_header(f)
        data = np.fromfile(f, np.dtype(order + "f4"), w * h * c)
    if data.size != w * h * c:
        raise IOError(f"truncated PFM file {path!r}")
    return data.reshape(h, w, c)[::-1].astype(np.float32)


def write_pfm(path: str, arr: np.ndarray) -> None:
    """Write (H, W, C) float32 pixels with 1 or 3 channels as a
    little-endian PFM file."""
    h, w, c = arr.shape
    if c not in (1, 3):
        raise ValueError(f"PFM holds 1 or 3 channels, not {c}")
    with open(path, "wb") as f:
        f.write(b"PF\n" if c == 3 else b"Pf\n")
        f.write(f"{w} {h}\n-1.0\n".encode())
        np.ascontiguousarray(arr[::-1], "<f4").tofile(f)


def _default_file_csp(path: str, arr_dtype) -> str:
    if _is_exr(path) or _is_pfm(path):
        return "scene_linear"
    if np.issubdtype(arr_dtype, np.floating):
        return "scene_linear"
    return "sRGB"


# camera RAW formats (the reference reads these through OIIO's libraw
# plugin, configured via --oiio raw:* keys, envutil_basic.h:843-905;
# here they go through rawpy when it is installed)
_RAW_EXTS = {".cr2", ".cr3", ".nef", ".arw", ".dng", ".orf", ".raf",
             ".rw2", ".pef", ".srw", ".raw", ".erf", ".kdc", ".mrw",
             ".nrw", ".sr2", ".srf", ".x3f", ".3fr", ".iiq"}


def _is_raw(path: str) -> bool:
    return pathlib.Path(path).suffix.lower() in _RAW_EXTS


def parse_oiio_options(options) -> list:
    """Parse --oiio plugin options in the reference's dialect
    (envutil_basic.h:843-905): each item is ``key[@TYPE]=value`` or a
    bare ``key``. Returns (key, typestring, value) triples."""
    out = []
    for attr in options or []:
        if "=" in attr:
            lhs, val = attr.split("=", 1)
        else:
            lhs, val = attr, ""
        if "@" in lhs:
            key, typ = lhs.split("@", 1)
        else:
            key, typ = lhs, ""
        out.append((key, typ, val))
    return out


def _read_raw(path: str, oiio_options, verbose: bool):
    """Decode a camera RAW via rawpy, honoring the OIIO raw:* config
    keys the reference forwards to its libraw plugin. Returns float32
    (H, W, 3) in [0,1] plus the effective colour space name."""
    try:
        import rawpy
    except ImportError as e:
        raise IOError(
            f"{path}: camera RAW input needs the 'rawpy' package, which "
            "is not installed in this environment (the reference uses "
            "OpenImageIO's libraw plugin here)") from e

    kw = dict(output_bps=16, use_camera_wb=True, no_auto_bright=True,
              gamma=(1.0, 1.0))
    csp = "scene_linear"
    for key, _typ, val in parse_oiio_options(oiio_options):
        if not key.startswith("raw:"):
            continue  # non-raw keys are handled by the caller
        sub = key[4:].lower()
        if sub == "colorspace":
            name = val.lower()
            spaces = {"srgb": rawpy.ColorSpace.sRGB,
                      "srgb-linear": rawpy.ColorSpace.sRGB,
                      "linear": rawpy.ColorSpace.raw,
                      "raw": rawpy.ColorSpace.raw,
                      "adobe": rawpy.ColorSpace.Adobe,
                      "wide": rawpy.ColorSpace.Wide,
                      "prophoto": rawpy.ColorSpace.ProPhoto,
                      "prophoto-linear": rawpy.ColorSpace.ProPhoto,
                      "xyz": rawpy.ColorSpace.XYZ,
                      "aces": rawpy.ColorSpace.ACES}
            if name in spaces:
                kw["output_color"] = spaces[name]
            if name == "srgb":
                kw["gamma"] = (2.222, 4.5)  # libraw's sRGB-ish default
                csp = "sRGB"
            elif verbose and name not in spaces:
                print(f"--oiio {key}={val}: unknown colour space, "
                      "keeping linear")
        elif sub == "use_camera_wb":
            kw["use_camera_wb"] = bool(int(val))
        elif sub == "auto_bright":
            kw["no_auto_bright"] = not bool(int(val))
        elif sub == "exposure":
            kw["exp_shift"] = float(val)
        elif sub == "user_flip":
            kw["user_flip"] = int(val)
        elif sub == "demosaic":
            try:
                kw["demosaic_algorithm"] = \
                    getattr(rawpy.DemosaicAlgorithm, val)
            except AttributeError:
                if verbose:
                    print(f"--oiio {key}={val}: unknown demosaic "
                          "algorithm, using default")
        elif sub == "highlightmode":
            kw["highlight_mode"] = int(val)
        elif verbose:
            print(f"--oiio {key}={val}: key not supported by the "
                  "rawpy backend, ignored")
    with rawpy.imread(path) as r:
        rgb = r.postprocess(**kw)
    return rgb.astype(np.float32) / 65535.0, csp


def read_image(path: str, colour_space: str = "",
               working_colour_space: str = "scene_linear",
               verbose: bool = False, oiio_options=None) -> np.ndarray:
    """Read an image file to interleaved float32 (H, W, C) in the
    working colour space. ``colour_space`` overrides the file's assumed
    colour space (the PTO 'Csp' extension / --input_colour_space).
    ``oiio_options`` is the --oiio plugin key list (reference
    envutil_basic.h:843-905); raw:* keys drive RAW decoding, other keys
    are specific to OIIO plugins this build does not use and warn."""
    if oiio_options and verbose:
        for key, typ, val in parse_oiio_options(oiio_options):
            if not key.startswith("raw:"):
                print(f"--oiio {key}"
                      + (f"@{typ}" if typ else "")
                      + f"={val}: no OIIO in this build; key has no "
                      "effect on non-RAW inputs")
    if _is_raw(path):
        arr, file_csp = _read_raw(path, oiio_options, verbose)
        csp = colour_space or file_csp
        if verbose:
            print(f"file {path} loaded: {arr.shape[1]}x{arr.shape[0]}"
                  f"#{arr.shape[2]}, colour space {csp}")
        return convert_colour(arr, csp, working_colour_space)
    if _is_exr(path):
        lib = _load_native()
        data = ctypes.POINTER(ctypes.c_float)()
        w = ctypes.c_int()
        h = ctypes.c_int()
        c = ctypes.c_int()
        rc = lib.envio_read_exr(str(path).encode(), ctypes.byref(data),
                                ctypes.byref(w), ctypes.byref(h),
                                ctypes.byref(c))
        if rc != 0:
            raise IOError(f"failed to read EXR {path!r} (rc={rc})")
        n = h.value * w.value * c.value
        arr = np.ctypeslib.as_array(data, shape=(n,)).astype(np.float32,
                                                             copy=True)
        lib.envio_free(data)
        arr = arr.reshape(h.value, w.value, c.value)
        native_dtype = np.float32
    elif _is_pfm(path):
        arr = read_pfm(path)
        native_dtype = np.float32
    else:
        import imageio.v3 as iio
        raw = iio.imread(path)
        native_dtype = raw.dtype
        if raw.ndim == 2:
            raw = raw[..., None]
        if np.issubdtype(raw.dtype, np.integer):
            arr = raw.astype(np.float32) / float(np.iinfo(raw.dtype).max)
        else:
            arr = raw.astype(np.float32)

    csp = colour_space or _default_file_csp(path, native_dtype)
    if verbose:
        print(f"file {path} loaded: {arr.shape[1]}x{arr.shape[0]}"
              f"#{arr.shape[2]}, colour space {csp}")
    return convert_colour(arr, csp, working_colour_space)


def read_image_metadata(path: str) -> dict:
    """Glean size/channels and (for EXR) Projection/Hfov metadata
    without loading pixel data where possible."""
    meta = {}
    if _is_raw(path):
        try:
            import rawpy
        except ImportError as e:
            raise IOError(
                f"{path}: camera RAW metadata needs 'rawpy', which is "
                "not installed in this environment") from e
        with rawpy.imread(path) as r:
            s = r.sizes
        meta["width"], meta["height"] = int(s.width), int(s.height)
        meta["nchannels"] = 3
        return meta
    if _is_exr(path):
        lib = _load_native()
        sval = ctypes.c_char_p()
        if lib.envio_read_exr_string_attr(str(path).encode(),
                                          b"Projection",
                                          ctypes.byref(sval)) == 0:
            meta["Projection"] = sval.value.decode()
        fval = ctypes.c_float()
        if lib.envio_read_exr_float_attr(str(path).encode(), b"Hfov",
                                         ctypes.byref(fval)) == 0:
            meta["Hfov"] = float(fval.value)
        # header-only probe: no pixel decode (the reference gleans
        # specs from the OIIO spec likewise, envutil_basic.h:545-630)
        w = ctypes.c_int()
        h = ctypes.c_int()
        c = ctypes.c_int()
        rc = lib.envio_read_exr_header(str(path).encode(),
                                       ctypes.byref(w), ctypes.byref(h),
                                       ctypes.byref(c))
        if rc != 0:
            raise IOError(f"cannot probe EXR header: {path} (rc={rc})")
        meta["width"], meta["height"] = int(w.value), int(h.value)
        meta["nchannels"] = int(c.value)
    elif _is_pfm(path):
        with open(path, "rb") as f:
            w, h, c, _order = _read_pfm_header(f)
        meta["width"], meta["height"], meta["nchannels"] = w, h, c
    else:
        import imageio.v3 as iio
        props = iio.improps(path)
        shp = props.shape
        meta["height"], meta["width"] = int(shp[0]), int(shp[1])
        meta["nchannels"] = int(shp[2]) if len(shp) > 2 else 1
    return meta


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def save_image(path: str, arr: np.ndarray, *,
               projection_name: str = "rectilinear",
               hfov_deg: float = 90.0,
               working_colour_space: str = "scene_linear",
               output_colour_space: str = "scene_linear",
               verbose: bool = False) -> None:
    """Save (H, W, C) float32 pixels. EXR via the native shim with
    Projection/Hfov metadata; LDR formats via imageio with conversion
    to 8/16 bit. JPEG output is forced to sRGB like the reference
    (envutil_basic.h:787-799). A '%s' in the path for cubemap data
    stores six separate cube faces (envutil_basic.h:726-757)."""
    path = str(path)
    arr = np.ascontiguousarray(arr, np.float32)
    h, w, c = arr.shape

    if "%s" in path and projection_name in ("cubemap", "biatan6"):
        assert h == 6 * w, "cubemap output must be a 1:6 stripe"
        for i, face in enumerate(FACE_NAMES):
            save_image(path % face, arr[i * w:(i + 1) * w],
                       projection_name="rectilinear", hfov_deg=90.0,
                       working_colour_space=working_colour_space,
                       output_colour_space=output_colour_space,
                       verbose=verbose)
        return

    target_csp = output_colour_space
    lower = path.lower()
    if lower.endswith((".jpg", ".jpeg")):
        if verbose:
            print("enforcing sRGB for JPEG output")
        target_csp = "sRGB"

    out = convert_colour(arr, working_colour_space, target_csp)

    if lower.endswith(".exr"):
        lib = _load_native()
        snames = (ctypes.c_char_p * 2)(b"ImageDescription", b"Projection")
        svals = (ctypes.c_char_p * 2)(
            b"image processed by envutil",
            projection_name.encode())
        fnames = (ctypes.c_char_p * 1)(b"Hfov")
        fvals = (ctypes.c_float * 1)(float(hfov_deg))
        rc = lib.envio_write_exr(
            path.encode(),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            w, h, c, snames, svals, 2, fnames, fvals, 1)
        if rc != 0:
            raise IOError(f"failed to write EXR {path!r} (rc={rc})")
    elif _is_pfm(path):
        write_pfm(path, out)
    elif lower.endswith((".tif", ".tiff")):
        import imageio.v3 as iio
        iio.imwrite(path, out)
    else:
        import imageio.v3 as iio
        u8 = np.clip(out * 255.0 + 0.5, 0, 255).astype(np.uint8)
        if u8.shape[-1] == 1:
            u8 = u8[..., 0]
        iio.imwrite(path, u8)
    if verbose:
        print(f"saved {path} ({w}x{h}#{c}, {target_csp})")
