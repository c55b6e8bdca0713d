// envio: minimal native OpenEXR I/O shim for envutil.
//
// The reference relies on OpenImageIO for image I/O
// (envutil_basic.h:823-986 read_image_data, :710-817 save_array). This
// framework keeps the hot path in XLA and routes float image I/O
// through this small C++ library (OpenEXR scanline files with metadata
// attributes); LDR formats (png/jpg/tiff) go through Python imageio.
//
// C ABI, used from Python via ctypes. All pixel data is interleaved
// float32, row-major, top-down, `nch` channels per pixel.

#include <ImfInputFile.h>
#include <ImfOutputFile.h>
#include <ImfChannelList.h>
#include <ImfStringAttribute.h>
#include <ImfFloatAttribute.h>
#include <ImfFrameBuffer.h>
#include <ImfHeader.h>
#include <ImathBox.h>

#include <cstring>
#include <cstdlib>
#include <string>
#include <vector>

using namespace Imf;
using namespace Imath;

extern "C" {

// Read an EXR file. On success returns 0 and fills out parameters;
// *data is malloc'd interleaved float32 (caller frees via envio_free).
// Channel order: R,G,B,A when present; otherwise Y[,A]; otherwise the
// file's channel order. *nch is the channel count.
int envio_read_exr(const char* path, float** data, int* width,
                   int* height, int* nch) {
  try {
    InputFile file(path);
    Box2i dw = file.header().dataWindow();
    const int w = dw.max.x - dw.min.x + 1;
    const int h = dw.max.y - dw.min.y + 1;

    const ChannelList& channels = file.header().channels();
    std::vector<std::string> names;
    // preferred orderings
    const char* rgba[] = {"R", "G", "B", "A"};
    const char* ya[] = {"Y", "A"};
    for (const char* n : rgba)
      if (channels.findChannel(n)) names.push_back(n);
    if (names.empty()) {
      for (const char* n : ya)
        if (channels.findChannel(n)) names.push_back(n);
    }
    if (names.empty()) {
      for (auto it = channels.begin(); it != channels.end(); ++it)
        names.push_back(it.name());
    }
    const int c = static_cast<int>(names.size());
    if (c == 0) return -2;

    float* buf = static_cast<float*>(
        malloc(sizeof(float) * static_cast<size_t>(w) * h * c));
    if (!buf) return -3;

    FrameBuffer fb;
    const size_t xs = sizeof(float) * c;
    const size_t ys = xs * w;
    for (int i = 0; i < c; ++i) {
      char* base = reinterpret_cast<char*>(buf + i) -
                   (dw.min.x * xs + dw.min.y * ys);
      fb.insert(names[i], Slice(FLOAT, base, xs, ys, 1, 1, 0.0));
    }
    file.setFrameBuffer(fb);
    file.readPixels(dw.min.y, dw.max.y);

    *data = buf;
    *width = w;
    *height = h;
    *nch = c;
    return 0;
  } catch (...) {
    return -1;
  }
}

// Header-only probe: width/height/channel count without decoding any
// pixel data (the reference gleans image specs from the OIIO spec the
// same way, envutil_basic.h:545-630). Returns 0 on success.
int envio_read_exr_header(const char* path, int* width, int* height,
                          int* nch) {
  try {
    InputFile file(path);
    Box2i dw = file.header().dataWindow();
    *width = dw.max.x - dw.min.x + 1;
    *height = dw.max.y - dw.min.y + 1;
    const ChannelList& channels = file.header().channels();
    const char* rgba[] = {"R", "G", "B", "A"};
    const char* ya[] = {"Y", "A"};
    int c = 0;
    for (const char* n : rgba)
      if (channels.findChannel(n)) ++c;
    if (c == 0)
      for (const char* n : ya)
        if (channels.findChannel(n)) ++c;
    if (c == 0)
      for (auto it = channels.begin(); it != channels.end(); ++it) ++c;
    if (c == 0) return -2;
    *nch = c;
    return 0;
  } catch (...) {
    return -1;
  }
}

// Read a named string attribute into a malloc'd buffer (caller frees).
// Returns 0 on success, 1 if absent, <0 on error.
int envio_read_exr_string_attr(const char* path, const char* name,
                               char** value) {
  try {
    InputFile file(path);
    const StringAttribute* a =
        file.header().findTypedAttribute<StringAttribute>(name);
    if (!a) return 1;
    *value = strdup(a->value().c_str());
    return 0;
  } catch (...) {
    return -1;
  }
}

// Read a named float attribute. Returns 0 on success, 1 if absent.
int envio_read_exr_float_attr(const char* path, const char* name,
                              float* value) {
  try {
    InputFile file(path);
    const FloatAttribute* a =
        file.header().findTypedAttribute<FloatAttribute>(name);
    if (!a) return 1;
    *value = a->value();
    return 0;
  } catch (...) {
    return -1;
  }
}

// Write a scanline float EXR with optional string/float attributes.
// nch: 1 -> Y, 2 -> Y+A, 3 -> RGB, 4 -> RGBA.
int envio_write_exr(const char* path, const float* data, int width,
                    int height, int nch, const char** sattr_names,
                    const char** sattr_vals, int n_sattr,
                    const char** fattr_names, const float* fattr_vals,
                    int n_fattr) {
  try {
    static const char* names1[] = {"Y"};
    static const char* names2[] = {"Y", "A"};
    static const char* names3[] = {"R", "G", "B"};
    static const char* names4[] = {"R", "G", "B", "A"};
    const char** names;
    switch (nch) {
      case 1: names = names1; break;
      case 2: names = names2; break;
      case 3: names = names3; break;
      case 4: names = names4; break;
      default: return -2;
    }

    Header header(width, height);
    for (int i = 0; i < n_sattr; ++i)
      header.insert(sattr_names[i], StringAttribute(sattr_vals[i]));
    for (int i = 0; i < n_fattr; ++i)
      header.insert(fattr_names[i], FloatAttribute(fattr_vals[i]));
    for (int i = 0; i < nch; ++i)
      header.channels().insert(names[i], Channel(FLOAT));

    OutputFile file(path, header);
    FrameBuffer fb;
    const size_t xs = sizeof(float) * nch;
    const size_t ys = xs * width;
    for (int i = 0; i < nch; ++i) {
      char* base = const_cast<char*>(
          reinterpret_cast<const char*>(data + i));
      fb.insert(names[i], Slice(FLOAT, base, xs, ys));
    }
    file.setFrameBuffer(fb);
    file.writePixels(height);
    return 0;
  } catch (...) {
    return -1;
  }
}

// ---------------------------------------------------------------------------
// scanline-granular access (the reference streams larger-than-RAM
// rasters scanline-wise through OIIO read_scanlines into a line store,
// zimt/scanlines.h:55-230; these handles are the native edge of the
// envutil LineStore / TileStore subsystem).
// ---------------------------------------------------------------------------

struct envio_in_handle {
  InputFile* file;
  std::vector<std::string> names;
  int width, height, nch;
  int min_x, min_y;
};

// Open an EXR for scanline reads. Returns NULL on failure.
void* envio_open_exr_in(const char* path, int* width, int* height,
                        int* nch) {
  try {
    auto* h = new envio_in_handle();
    h->file = new InputFile(path);
    Box2i dw = h->file->header().dataWindow();
    h->width = dw.max.x - dw.min.x + 1;
    h->height = dw.max.y - dw.min.y + 1;
    h->min_x = dw.min.x;
    h->min_y = dw.min.y;
    const ChannelList& channels = h->file->header().channels();
    const char* rgba[] = {"R", "G", "B", "A"};
    const char* ya[] = {"Y", "A"};
    for (const char* n : rgba)
      if (channels.findChannel(n)) h->names.push_back(n);
    if (h->names.empty())
      for (const char* n : ya)
        if (channels.findChannel(n)) h->names.push_back(n);
    if (h->names.empty())
      for (auto it = channels.begin(); it != channels.end(); ++it)
        h->names.push_back(it.name());
    h->nch = static_cast<int>(h->names.size());
    if (h->nch == 0) { delete h->file; delete h; return nullptr; }
    *width = h->width;
    *height = h->height;
    *nch = h->nch;
    return h;
  } catch (...) {
    return nullptr;
  }
}

// Read ``n`` scanlines starting at image row ``y0`` (0-based, top-down)
// into caller-provided interleaved float32 ``buf`` (n * width * nch).
int envio_read_exr_scanlines(void* handle, int y0, int n, float* buf) {
  try {
    auto* h = static_cast<envio_in_handle*>(handle);
    if (y0 < 0 || n <= 0 || y0 + n > h->height) return -2;
    FrameBuffer fb;
    const size_t xs = sizeof(float) * h->nch;
    const size_t ys = xs * h->width;
    // base is laid out so that file row (min_y + y0) lands at buf[0]
    for (int i = 0; i < h->nch; ++i) {
      char* base = reinterpret_cast<char*>(buf + i) -
                   (h->min_x * xs + (h->min_y + y0) * ys);
      fb.insert(h->names[i], Slice(FLOAT, base, xs, ys, 1, 1, 0.0));
    }
    h->file->setFrameBuffer(fb);
    h->file->readPixels(h->min_y + y0, h->min_y + y0 + n - 1);
    return 0;
  } catch (...) {
    return -1;
  }
}

void envio_close_exr_in(void* handle) {
  auto* h = static_cast<envio_in_handle*>(handle);
  if (!h) return;
  delete h->file;
  delete h;
}

struct envio_out_handle {
  OutputFile* file;
  int width, height, nch;
  int next_y;
};

static const char** channel_names_for(int nch) {
  static const char* names1[] = {"Y"};
  static const char* names2[] = {"Y", "A"};
  static const char* names3[] = {"R", "G", "B"};
  static const char* names4[] = {"R", "G", "B", "A"};
  switch (nch) {
    case 1: return names1;
    case 2: return names2;
    case 3: return names3;
    case 4: return names4;
    default: return nullptr;
  }
}

// Open an EXR for sequential scanline writes (top-down).
void* envio_open_exr_out(const char* path, int width, int height,
                         int nch, const char** sattr_names,
                         const char** sattr_vals, int n_sattr,
                         const char** fattr_names,
                         const float* fattr_vals, int n_fattr) {
  try {
    const char** names = channel_names_for(nch);
    if (!names) return nullptr;
    Header header(width, height);
    for (int i = 0; i < n_sattr; ++i)
      header.insert(sattr_names[i], StringAttribute(sattr_vals[i]));
    for (int i = 0; i < n_fattr; ++i)
      header.insert(fattr_names[i], FloatAttribute(fattr_vals[i]));
    for (int i = 0; i < nch; ++i)
      header.channels().insert(names[i], Channel(FLOAT));
    auto* h = new envio_out_handle();
    h->file = new OutputFile(path, header);
    h->width = width;
    h->height = height;
    h->nch = nch;
    h->next_y = 0;
    return h;
  } catch (...) {
    return nullptr;
  }
}

// Write ``n`` scanlines (must be sequential from the last call) from
// interleaved float32 ``buf`` (n * width * nch).
int envio_write_exr_scanlines(void* handle, int n, const float* buf) {
  try {
    auto* h = static_cast<envio_out_handle*>(handle);
    if (n <= 0 || h->next_y + n > h->height) return -2;
    const char** names = channel_names_for(h->nch);
    FrameBuffer fb;
    const size_t xs = sizeof(float) * h->nch;
    const size_t ys = xs * h->width;
    for (int i = 0; i < h->nch; ++i) {
      char* base = const_cast<char*>(
          reinterpret_cast<const char*>(buf + i)) - h->next_y * ys;
      fb.insert(names[i], Slice(FLOAT, base, xs, ys));
    }
    h->file->setFrameBuffer(fb);
    h->file->writePixels(n);
    h->next_y += n;
    return 0;
  } catch (...) {
    return -1;
  }
}

int envio_close_exr_out(void* handle) {
  auto* h = static_cast<envio_out_handle*>(handle);
  if (!h) return -1;
  int rc = (h->next_y == h->height) ? 0 : 1;  // 1: short file
  delete h->file;
  delete h;
  return rc;
}

void envio_free(void* p) { free(p); }

}  // extern "C"
