// ASCII-PLY point-cloud writer: the port's own copy of the JAX package's
// native writer, byte for byte the same output.
//
// The reference exports its clouds through trimesh (utils/pvd_utils.py:438-473:
// ASCII PLY with xyz, zero normals and uchar rgb). The clouds are large
// (n_views * 288 * 512, up to ~1.5M points in the iterative modes); a buffered
// C writer is ~20x faster than a Python loop over the points.
//
// Built on first use by viewcrafter_tpu_torch/utils/io.py (g++ -O3 -shared
// -fPIC into viewcrafter_tpu_torch/_build/) and loaded through ctypes.

#include <cstdio>
#include <cstdlib>
#include <cstring>

namespace {

// float -> decimal via snprintf into a local buffer; %.6g, six significant
// digits
inline int fmt_float(char* dst, float v) { return std::snprintf(dst, 32, "%.6g", v); }

}  // namespace

extern "C" {

// Returns 0 on success, negative codes on failure.
int vc_write_ply(const char* path, const float* pts, const unsigned char* rgb, long n_points) {
    std::FILE* f = std::fopen(path, "wb");
    if (!f) return -1;

    // a 1 MiB stdio buffer keeps syscalls rare
    std::setvbuf(f, nullptr, _IOFBF, 1 << 20);

    std::fprintf(f,
                 "ply\nformat ascii 1.0\n"
                 "element vertex %ld\n"
                 "property float x\nproperty float y\nproperty float z\n"
                 "property float nx\nproperty float ny\nproperty float nz\n"
                 "property uchar red\nproperty uchar green\nproperty uchar blue\n"
                 "end_header\n",
                 n_points);

    char line[160];
    for (long i = 0; i < n_points; ++i) {
        char* p = line;
        p += fmt_float(p, pts[3 * i + 0]);
        *p++ = ' ';
        p += fmt_float(p, pts[3 * i + 1]);
        *p++ = ' ';
        p += fmt_float(p, pts[3 * i + 2]);
        p += std::snprintf(p, 48, " 0 0 0 %u %u %u\n", rgb[3 * i + 0], rgb[3 * i + 1],
                           rgb[3 * i + 2]);
        if (std::fwrite(line, 1, p - line, f) != static_cast<size_t>(p - line)) {
            std::fclose(f);
            return -2;
        }
    }
    if (std::fclose(f) != 0) return -3;
    return 0;
}

}  // extern "C"
