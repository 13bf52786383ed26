// Native EXR reader shim over the system OpenEXR 3.x library.
//
// The pure-Python reader (ignis_tpu_torch/utils/exr.py) handles the
// uncompressed, ZIPS and ZIP scanline files; this shim reads every other
// compression (PIZ, RLE, PXR24, B44, DWA).  Same C ABI as the
// JAX package's shim.
//
// Built at first use by `ignis_tpu_torch.native.load_exr_shim` with g++ and
// loaded through ctypes:
//   g++ -O2 -shared -fPIC -I/usr/include/OpenEXR -I/usr/include/Imath \
//       exr_shim.cpp -lOpenEXR-3_1 -lImath-3_1 -lIlmThread-3_1 -lIex-3_1

#include <ImfArray.h>
#include <ImfRgbaFile.h>

using namespace Imf;
using namespace Imath;

extern "C" {

// Returns 0 on success and fills *w / *h with the data-window size.
int ig_exr_read_size(const char* path, int* w, int* h)
{
    try {
        RgbaInputFile f(path);
        Box2i dw = f.dataWindow();
        *w = dw.max.x - dw.min.x + 1;
        *h = dw.max.y - dw.min.y + 1;
        return 0;
    } catch (...) {
        return -1;
    }
}

// out must hold h*w*4 floats (RGBA scanline order, top-down).
int ig_exr_read(const char* path, float* out)
{
    try {
        RgbaInputFile f(path);
        Box2i dw = f.dataWindow();
        const int w = dw.max.x - dw.min.x + 1;
        const int h = dw.max.y - dw.min.y + 1;
        Array2D<Rgba> px(h, w);
        f.setFrameBuffer(&px[0][0] - dw.min.x - (long long)dw.min.y * w, 1, w);
        f.readPixels(dw.min.y, dw.max.y);
        for (int y = 0; y < h; ++y) {
            for (int x = 0; x < w; ++x) {
                const Rgba& p = px[y][x];
                float* o = out + 4ll * ((long long)y * w + x);
                o[0] = p.r;
                o[1] = p.g;
                o[2] = p.b;
                o[3] = p.a;
            }
        }
        return 0;
    } catch (...) {
        return -1;
    }
}

}  // extern "C"
