// Native host runtime for raymarching_tpu.
//
// The reference keeps its host runtime in C++: the scene text parser
// (scene.cpp:92-190), the CSG generators (body.cpp:113-170), and the
// tree -> device-table flattener (render.cpp:246-366).  This library is the
// JAX renderer's equivalent: it parses the identical objects.txt grammar and
// emits the framework's flat struct-of-arrays tables directly in the
// two-level kernel normal form (group id + fold sign per primitive) —
// no pointer tree, no device-side interpreter.  Exposed via a minimal
// C ABI consumed through ctypes (raymarching_tpu/native.py).
//
// Build: make native   -> libraymarch_host.so (links system zlib for PNG).

#include <array>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <sstream>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

enum PrimKind : int32_t { SPHERE = 0, BOX = 1, CROSS = 2, MANDELBOX = 3,
                          MANDELBULB = 4, JULIA = 5 };

struct Prim {
    int32_t type;
    float pos[3];
    float aux[3];    // sphere: (radius, 0, 0); box/cross: size;
                     // fractals: (size, param, iterations) — the ctypes
                     // layer splits the structural (param, iters) pair
                     // back out into plan statics (native.py)
    float color[3];
    float extra[4] = {0, 0, 0, 0};  // Julia quaternion constant c
    int32_t group;   // group index (root child)
    float scale;     // fold sign inside the group's min-reduction
};

struct Group {
    int32_t gsign;   // group value = gsign * min(scale_i * sd_i)
    int32_t count;
};

struct ParsedScene {
    std::vector<Prim> prims;
    std::vector<Group> groups;
    std::vector<float> lights;           // L * 3
    std::vector<float> light_colors;     // L * 3 (LightColor extension)
    float cur_light_color[3] = {1, 1, 1};
    float camera[10] = {0, 0, 0, 0, 0, -1, 0, 1, 0, 90};  // pos, dir, up, fov
};

// The 20 Menger subcell offsets in reference order (body.cpp:119-144):
// front 8 (z=-1), back 8 (z=+1), middle 4 (z=0).
const int kMengerOffsets[20][3] = {
    {1, -1, -1}, {0, -1, -1}, {-1, -1, -1}, {1, 1, -1}, {0, 1, -1},
    {-1, 1, -1}, {-1, 0, -1}, {1, 0, -1},
    {1, -1, 1}, {0, -1, 1}, {-1, -1, 1}, {1, 1, 1}, {0, 1, 1},
    {-1, 1, 1}, {-1, 0, 1}, {1, 0, 1},
    {-1, -1, 0}, {1, -1, 0}, {-1, 1, 0}, {1, 1, 0},
};

void pushPrim(ParsedScene &s, int32_t type, const float pos[3],
              const float aux[3], const float color[3], int32_t group,
              float scale) {
    Prim p;
    p.type = type;
    std::memcpy(p.pos, pos, sizeof p.pos);
    std::memcpy(p.aux, aux, sizeof p.aux);
    std::memcpy(p.color, color, sizeof p.color);
    p.group = group;
    p.scale = scale;
    s.prims.push_back(p);
}

// A bare primitive at the root: its own singleton min-group.
int32_t newGroup(ParsedScene &s, int32_t gsign) {
    s.groups.push_back({gsign, 0});
    return static_cast<int32_t>(s.groups.size()) - 1;
}

void mengerRecurse(ParsedScene &s, int32_t group, const float pos[3],
                   float size, int iterations, const float color[3]) {
    const float d = size / 3.0f;
    // DIFFERENCE group lowered to -min(...): first element scale -1,
    // subtracted crosses scale +1 (compile.py _kernel_normal_form).
    float aux[3] = {d, d, d};
    pushPrim(s, CROSS, pos, aux, color, group, +1.0f);
    s.groups[group].count++;
    if (iterations >= 2) {
        for (const auto &off : kMengerOffsets) {
            float sub[3] = {pos[0] + off[0] * d, pos[1] + off[1] * d,
                            pos[2] + off[2] * d};
            mengerRecurse(s, group, sub, d, iterations - 1, color);
        }
    }
}

// Numeric "r g b" or a defined material name (parser.py resolve_color).
bool readColor(std::istringstream &in,
               const std::map<std::string, std::array<float, 3>> &materials,
               float dst[3]) {
    std::string first;
    if (!(in >> first)) return false;
    char *end = nullptr;
    float r = std::strtof(first.c_str(), &end);
    if (end != first.c_str() && end && *end == '\0') {
        if (!(in >> dst[1] >> dst[2])) return false;
        dst[0] = r;
        return true;
    }
    auto it = materials.find(first);
    if (it == materials.end()) return false;   // unknown material
    std::memcpy(dst, it->second.data(), 3 * sizeof(float));
    return true;
}

// Mirror of compile.py::_merge_trivial_groups: adjacent PLAIN groups
// (gsign +1, every member scale +1) under the MIN root coalesce into one.
// Semantically invisible — min is associative and the strict-< winner
// selections keep the earliest leaf either way — and it is what makes
// root-level object runs foldable (fori) and cullable (GroupPlan.bvh)
// on the kernel side.  Prims of a group are contiguous by construction
// (parse order), so adjacent group ids are adjacent leaf ranges.
void mergeTrivialGroups(ParsedScene &s) {
    const size_t G = s.groups.size();
    if (G < 2) return;
    std::vector<char> plain(G, 0);
    for (size_t g = 0; g < G; ++g) plain[g] = (s.groups[g].gsign == 1);
    for (const auto &p : s.prims)
        if (p.scale != 1.0f) plain[p.group] = 0;
    std::vector<int32_t> remap(G);
    std::vector<Group> merged;
    for (size_t g = 0; g < G; ++g) {
        if (g > 0 && plain[g] && plain[g - 1]) {
            remap[g] = static_cast<int32_t>(merged.size()) - 1;
            merged.back().count += s.groups[g].count;
        } else {
            remap[g] = static_cast<int32_t>(merged.size());
            merged.push_back(s.groups[g]);
        }
    }
    for (auto &p : s.prims) p.group = remap[p.group];
    s.groups = std::move(merged);
}

bool parseScene(const char *text, ParsedScene &out) {
    std::istringstream stream(text);
    std::string line;
    float color[3] = {1.0f, 1.0f, 1.0f};
    std::map<std::string, std::array<float, 3>> materials;

    while (std::getline(stream, line)) {
        std::istringstream in(line);
        std::string cmd;
        if (!(in >> cmd)) continue;

        if (cmd == "Sphere") {
            float pos[3], r;
            if (!(in >> pos[0] >> pos[1] >> pos[2] >> r)) return false;
            float aux[3] = {r, 0, 0};
            int32_t g = newGroup(out, +1);
            pushPrim(out, SPHERE, pos, aux, color, g, +1.0f);
            out.groups[g].count++;
        } else if (cmd == "Box" || cmd == "Cross") {
            float pos[3], size[3];
            if (!(in >> pos[0] >> pos[1] >> pos[2]
                     >> size[0] >> size[1] >> size[2])) return false;
            int32_t g = newGroup(out, +1);
            pushPrim(out, cmd == "Box" ? BOX : CROSS, pos, size, color, g,
                     +1.0f);
            out.groups[g].count++;
        } else if (cmd == "Mandelbox") {
            // Extension keyword (parser.py): optional trailing
            // (scale, iterations) default to (2, 8).
            float pos[3], size;
            if (!(in >> pos[0] >> pos[1] >> pos[2] >> size)) return false;
            float mscale = 2.0f;
            int iterations = 8;
            // (a failed C++11 extraction zeroes its target — keep the
            // defaults by reading through temporaries)
            float ms;
            if (in >> ms) mscale = ms;
            int it;
            if (in >> it) iterations = it;
            float aux[3] = {size, mscale, static_cast<float>(iterations)};
            int32_t g = newGroup(out, +1);
            pushPrim(out, MANDELBOX, pos, aux, color, g, +1.0f);
            out.groups[g].count++;
        } else if (cmd == "Mandelbulb") {
            // Extension keyword (parser.py): optional trailing iterations
            // defaults to 6; the power is fixed at 8 (aux[1], for ABI
            // symmetry with Mandelbox's (param, iterations) pair).
            float pos[3], size;
            if (!(in >> pos[0] >> pos[1] >> pos[2] >> size)) return false;
            int iterations = 6;
            int it;
            if (in >> it) iterations = it;
            float aux[3] = {size, 8.0f, static_cast<float>(iterations)};
            int32_t g = newGroup(out, +1);
            pushPrim(out, MANDELBULB, pos, aux, color, g, +1.0f);
            out.groups[g].count++;
        } else if (cmd == "Julia") {
            // Extension keyword (parser.py): quaternion constant c (4
            // floats, structural) rides the Prim.extra slots over the
            // C ABI; optional trailing iterations defaults to 11.
            float pos[3], size, c4[4];
            if (!(in >> pos[0] >> pos[1] >> pos[2] >> size
                     >> c4[0] >> c4[1] >> c4[2] >> c4[3])) return false;
            int iterations = 11;
            int it;
            if (in >> it) iterations = it;
            float aux[3] = {size, 0.0f, static_cast<float>(iterations)};
            int32_t g = newGroup(out, +1);
            pushPrim(out, JULIA, pos, aux, color, g, +1.0f);
            std::memcpy(out.prims.back().extra, c4, sizeof c4);
            out.groups[g].count++;
        } else if (cmd == "Bounds") {
            // COMPLEMENT list of one black box (scene.cpp:120-127):
            // value = min(-sd) => gsign +1, scale -1.
            float size;
            if (!(in >> size)) return false;
            float pos[3] = {0, 0, 0};
            float aux[3] = {size, size, size};
            float black[3] = {0, 0, 0};
            int32_t g = newGroup(out, +1);
            pushPrim(out, BOX, pos, aux, black, g, -1.0f);
            out.groups[g].count++;
        } else if (cmd == "DeathStar") {
            // DIFFERENCE: max(s0, -s1) = -min(-s0, s1)  (body.cpp:159-169)
            float pos[3], r;
            if (!(in >> pos[0] >> pos[1] >> pos[2] >> r)) return false;
            float aux[3] = {r, 0, 0};
            int32_t g = newGroup(out, -1);
            pushPrim(out, SPHERE, pos, aux, color, g, -1.0f);
            float dpos[3] = {pos[0] + 1.5f * r, pos[1], pos[2]};
            pushPrim(out, SPHERE, dpos, aux, color, g, +1.0f);
            out.groups[g].count += 2;
        } else if (cmd == "MengerSponge") {
            float pos[3], size;
            int iterations;
            if (!(in >> pos[0] >> pos[1] >> pos[2] >> size >> iterations))
                return false;
            int32_t g = newGroup(out, -1);
            float aux[3] = {size, size, size};
            pushPrim(out, BOX, pos, aux, color, g, -1.0f);
            out.groups[g].count++;
            mengerRecurse(out, g, pos, size, iterations, color);
        } else if (cmd == "Light") {
            float pos[3];
            if (!(in >> pos[0] >> pos[1] >> pos[2])) return false;
            out.lights.insert(out.lights.end(), pos, pos + 3);
            out.light_colors.insert(out.light_colors.end(),
                                    out.cur_light_color,
                                    out.cur_light_color + 3);
        } else if (cmd == "LightColor") {
            // Extension keyword (parser.py): a running current light color
            // applied to subsequent Light lines; default white.
            if (!readColor(in, materials, out.cur_light_color)) return false;
        } else if (cmd == "Material") {
            // Extension keyword (parser.py): named reusable color, pure
            // sugar over the running-color state; later definition wins.
            std::string name;
            float c[3];
            if (!(in >> name >> c[0] >> c[1] >> c[2])) return false;
            materials[name] = {c[0], c[1], c[2]};
        } else if (cmd == "Camera") {
            std::string sub;
            if (!(in >> sub)) return false;
            if (sub == "Position") {
                if (!(in >> out.camera[0] >> out.camera[1] >> out.camera[2]))
                    return false;
            } else if (sub == "Direction") {
                if (!(in >> out.camera[3] >> out.camera[4] >> out.camera[5]))
                    return false;
            } else if (sub == "Up") {
                if (!(in >> out.camera[6] >> out.camera[7] >> out.camera[8]))
                    return false;
            } else if (sub == "FOV") {
                if (!(in >> out.camera[9])) return false;
            }
        } else if (cmd == "Color") {
            if (!readColor(in, materials, color)) return false;
        }
        // Unknown keywords are ignored, like the reference loader.
    }
    mergeTrivialGroups(out);
    return true;
}

// ---------------------------------------------------------------------------
// Baseline JPEG encoder (JFIF, 4:4:4) — the native twin of io/jpeg.py,
// standing in for the reference's vendored stb_image_write JPEG path
// (main.cpp:80).  Standard Annex-K quantization + Huffman tables, libjpeg
// quality curve, 8x8 float DCT, interleaved 1x1-sampling MCUs.
// ---------------------------------------------------------------------------
namespace jpegenc {

const int kQLuma[64] = {
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const int kQChroma[64] = {
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
    99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};
const int kZigzag[64] = {
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63};

const uint8_t kDcLumaBits[16] = {0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0,
                                 0, 0};
const uint8_t kDcChromaBits[16] = {0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0,
                                   0, 0, 0};
const uint8_t kDcVals[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kAcLumaBits[16] = {0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0,
                                 1, 0x7D};
const uint8_t kAcLumaVals[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41,
    0x06, 0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91,
    0xA1, 0x08, 0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24,
    0x33, 0x62, 0x72, 0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A,
    0x25, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38,
    0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53,
    0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65, 0x66,
    0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79,
    0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A, 0x92, 0x93,
    0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3, 0xA4, 0xA5,
    0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6, 0xB7,
    0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2,
    0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA};
const uint8_t kAcChromaBits[16] = {0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0,
                                   1, 2, 0x77};
const uint8_t kAcChromaVals[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12,
    0x41, 0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14,
    0x42, 0x91, 0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15,
    0x62, 0x72, 0xD1, 0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17,
    0x18, 0x19, 0x1A, 0x26, 0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37,
    0x38, 0x39, 0x3A, 0x43, 0x44, 0x45, 0x46, 0x47, 0x48, 0x49, 0x4A,
    0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5A, 0x63, 0x64, 0x65,
    0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78,
    0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8A,
    0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5,
    0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9,
    0xDA, 0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2,
    0xF3, 0xF4, 0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA};

struct Huff {
    uint16_t code[256];
    uint8_t len[256];
};

void buildHuff(const uint8_t bits[16], const uint8_t *vals, Huff &h) {
    std::memset(h.len, 0, sizeof h.len);
    int code = 0, k = 0;
    for (int length = 1; length <= 16; ++length) {
        for (int i = 0; i < bits[length - 1]; ++i) {
            h.code[vals[k]] = static_cast<uint16_t>(code);
            h.len[vals[k]] = static_cast<uint8_t>(length);
            ++code;
            ++k;
        }
        code <<= 1;
    }
}

struct BitWriter {
    std::vector<uint8_t> buf;
    uint32_t acc = 0;
    int nbits = 0;

    void put(uint32_t code, int length) {
        acc = (acc << length) | (code & ((1u << length) - 1));
        nbits += length;
        while (nbits >= 8) {
            nbits -= 8;
            uint8_t byte = static_cast<uint8_t>((acc >> nbits) & 0xFF);
            buf.push_back(byte);
            if (byte == 0xFF) buf.push_back(0x00);  // byte stuffing
        }
    }
    void flush() {
        if (nbits) put(0x7F, 8 - nbits);            // pad with 1s
    }
};

// category size + offset-coded value bits (JPEG magnitude coding)
inline void magnitude(int v, int &size, int &bits) {
    if (v == 0) { size = 0; bits = 0; return; }
    int a = v < 0 ? -v : v;
    size = 0;
    while (a >> size) ++size;
    bits = v > 0 ? v : v + (1 << size) - 1;
}

void fdct8x8(const double in[64], double out[64]) {
    // C++11 magic static: thread-safe one-time init (serve.py's threaded
    // HTTP server can call rm_write_jpeg concurrently; ctypes drops the
    // GIL during the call)
    static const std::array<std::array<double, 8>, 8> D = [] {
        std::array<std::array<double, 8>, 8> d{};
        for (int k = 0; k < 8; ++k)
            for (int n = 0; n < 8; ++n)
                d[k][n] = (k == 0 ? std::sqrt(0.125) : 0.5) *
                          std::cos((2 * n + 1) * k * M_PI / 16.0);
        return d;
    }();
    double tmp[64];
    for (int k = 0; k < 8; ++k)              // rows: D * in
        for (int j = 0; j < 8; ++j) {
            double s = 0;
            for (int n = 0; n < 8; ++n) s += D[k][n] * in[n * 8 + j];
            tmp[k * 8 + j] = s;
        }
    for (int i = 0; i < 8; ++i)              // cols: tmp * D^T
        for (int l = 0; l < 8; ++l) {
            double s = 0;
            for (int n = 0; n < 8; ++n) s += tmp[i * 8 + n] * D[l][n];
            out[i * 8 + l] = s;
        }
}

void encodeBlock(BitWriter &bw, const int zz[64], const Huff &dc,
                 const Huff &ac, int &pred) {
    int size, bits;
    int diff = zz[0] - pred;
    pred = zz[0];
    magnitude(diff, size, bits);
    bw.put(dc.code[size], dc.len[size]);
    if (size) bw.put(static_cast<uint32_t>(bits), size);

    int end = 1;
    for (int k = 63; k >= 1; --k)
        if (zz[k] != 0) { end = k + 1; break; }
    int run = 0;
    for (int k = 1; k < end; ++k) {
        if (zz[k] == 0) { ++run; continue; }
        while (run > 15) {
            bw.put(ac.code[0xF0], ac.len[0xF0]);   // ZRL
            run -= 16;
        }
        magnitude(zz[k], size, bits);
        int sym = (run << 4) | size;
        bw.put(ac.code[sym], ac.len[sym]);
        bw.put(static_cast<uint32_t>(bits), size);
        run = 0;
    }
    if (end < 64) bw.put(ac.code[0x00], ac.len[0x00]);  // EOB
}

}  // namespace jpegenc

}  // namespace

extern "C" {

int rm_parse_scene_counts(const char *text, int32_t *num_prims,
                          int32_t *num_lights) {
    ParsedScene s;
    if (!parseScene(text, s)) return 1;
    *num_prims = static_cast<int32_t>(s.prims.size());
    *num_lights = static_cast<int32_t>(s.lights.size() / 3);
    return 0;
}

int rm_parse_scene_fill(const char *text, int32_t *prim_type, float *prim_pos,
                        float *prim_aux, float *prim_color, int32_t *group_id,
                        int32_t *group_count, int32_t *group_meta,
                        float *prim_scale, float *lights, float *camera,
                        float *prim_extra, float *light_colors) {
    ParsedScene s;
    if (!parseScene(text, s)) return 1;
    for (size_t i = 0; i < s.prims.size(); ++i) {
        const Prim &p = s.prims[i];
        prim_type[i] = p.type;
        std::memcpy(prim_pos + 3 * i, p.pos, sizeof p.pos);
        std::memcpy(prim_aux + 3 * i, p.aux, sizeof p.aux);
        std::memcpy(prim_color + 3 * i, p.color, sizeof p.color);
        std::memcpy(prim_extra + 4 * i, p.extra, sizeof p.extra);
        group_id[i] = p.group;
        prim_scale[i] = p.scale;
    }
    *group_count = static_cast<int32_t>(s.groups.size());
    for (size_t g = 0; g < s.groups.size(); ++g) {
        group_meta[2 * g] = s.groups[g].gsign;
        group_meta[2 * g + 1] = s.groups[g].count;
    }
    std::memcpy(lights, s.lights.data(), s.lights.size() * sizeof(float));
    std::memcpy(light_colors, s.light_colors.data(),
                s.light_colors.size() * sizeof(float));
    std::memcpy(camera, s.camera, sizeof s.camera);
    return 0;
}

// Minimal PNG writer (8-bit RGB/RGBA, filter 0, zlib-deflated) — the
// clean-room stand-in for the reference's vendored stb_image_write.
int rm_write_png(const char *path, int width, int height, int channels,
                 const uint8_t *data) {
    if (channels != 3 && channels != 4) return 2;

    const size_t stride = static_cast<size_t>(width) * channels;
    std::vector<uint8_t> raw((stride + 1) * height);
    for (int y = 0; y < height; ++y) {
        raw[(stride + 1) * y] = 0;  // filter type 0
        std::memcpy(&raw[(stride + 1) * y + 1], data + stride * y, stride);
    }

    uLongf bound = compressBound(raw.size());
    std::vector<uint8_t> idat(bound);
    if (compress2(idat.data(), &bound, raw.data(), raw.size(), 6) != Z_OK)
        return 3;
    idat.resize(bound);

    FILE *f = std::fopen(path, "wb");
    if (!f) return 4;

    auto be32 = [](uint32_t v, uint8_t *out) {
        out[0] = v >> 24; out[1] = v >> 16; out[2] = v >> 8; out[3] = v;
    };
    auto writeChunk = [&](const char *tag, const uint8_t *payload,
                          uint32_t len) {
        uint8_t hdr[8];
        be32(len, hdr);
        std::memcpy(hdr + 4, tag, 4);
        std::fwrite(hdr, 1, 8, f);
        if (len) std::fwrite(payload, 1, len, f);
        uLong crc = crc32(0L, hdr + 4, 4);
        if (len) crc = crc32(crc, payload, len);
        uint8_t tail[4];
        be32(static_cast<uint32_t>(crc), tail);
        std::fwrite(tail, 1, 4, f);
    };

    const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
    std::fwrite(sig, 1, 8, f);
    uint8_t ihdr[13];
    be32(static_cast<uint32_t>(width), ihdr);
    be32(static_cast<uint32_t>(height), ihdr + 4);
    ihdr[8] = 8;                          // bit depth
    ihdr[9] = channels == 3 ? 2 : 6;      // color type
    ihdr[10] = ihdr[11] = ihdr[12] = 0;
    writeChunk("IHDR", ihdr, 13);
    writeChunk("IDAT", idat.data(), static_cast<uint32_t>(idat.size()));
    writeChunk("IEND", nullptr, 0);
    std::fclose(f);
    return 0;
}

// Baseline JFIF writer (4:4:4, quality per the libjpeg curve) — see the
// jpegenc namespace above; io/jpeg.py is the Python twin.
int rm_write_jpeg(const char *path, int width, int height,
                  const uint8_t *rgb, int quality) {
    using namespace jpegenc;
    if (width <= 0 || height <= 0) return 2;
    if (quality < 1) quality = 1;
    if (quality > 100) quality = 100;
    const int scale = quality < 50 ? 5000 / quality : 200 - quality * 2;
    int ql[64], qc[64];
    for (int i = 0; i < 64; ++i) {
        int l = (kQLuma[i] * scale + 50) / 100;
        int c = (kQChroma[i] * scale + 50) / 100;
        ql[i] = l < 1 ? 1 : (l > 255 ? 255 : l);
        qc[i] = c < 1 ? 1 : (c > 255 ? 255 : c);
    }

    Huff dcL, dcC, acL, acC;
    buildHuff(kDcLumaBits, kDcVals, dcL);
    buildHuff(kDcChromaBits, kDcVals, dcC);
    buildHuff(kAcLumaBits, kAcLumaVals, acL);
    buildHuff(kAcChromaBits, kAcChromaVals, acC);

    std::vector<uint8_t> out;
    auto byte = [&](uint8_t b) { out.push_back(b); };
    auto be16 = [&](uint16_t v) { byte(v >> 8); byte(v & 0xFF); };
    auto marker = [&](uint16_t tag, const std::vector<uint8_t> &payload) {
        be16(tag);
        be16(static_cast<uint16_t>(payload.size() + 2));
        out.insert(out.end(), payload.begin(), payload.end());
    };

    byte(0xFF); byte(0xD8);                                   // SOI
    marker(0xFFE0, {'J', 'F', 'I', 'F', 0, 1, 1, 0, 0, 1, 0, 1, 0, 0});
    std::vector<uint8_t> dqt;                                 // DQT
    dqt.push_back(0);
    for (int i = 0; i < 64; ++i)
        dqt.push_back(static_cast<uint8_t>(ql[kZigzag[i]]));
    dqt.push_back(1);
    for (int i = 0; i < 64; ++i)
        dqt.push_back(static_cast<uint8_t>(qc[kZigzag[i]]));
    marker(0xFFDB, dqt);
    std::vector<uint8_t> sof = {                              // SOF0
        8,
        static_cast<uint8_t>(height >> 8), static_cast<uint8_t>(height),
        static_cast<uint8_t>(width >> 8), static_cast<uint8_t>(width),
        3, 1, 0x11, 0, 2, 0x11, 1, 3, 0x11, 1};
    marker(0xFFC0, sof);
    const struct { int cls, id; const uint8_t *bits, *vals; int n; } hts[4] =
        {{0, 0, kDcLumaBits, kDcVals, 12},
         {1, 0, kAcLumaBits, kAcLumaVals, 162},
         {0, 1, kDcChromaBits, kDcVals, 12},
         {1, 1, kAcChromaBits, kAcChromaVals, 162}};
    for (const auto &t : hts) {                               // DHT x4
        std::vector<uint8_t> dht;
        dht.push_back(static_cast<uint8_t>((t.cls << 4) | t.id));
        dht.insert(dht.end(), t.bits, t.bits + 16);
        dht.insert(dht.end(), t.vals, t.vals + t.n);
        marker(0xFFC4, dht);
    }
    marker(0xFFDA, {3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0});  // SOS

    // Interleaved MCUs, 1x1 sampling: Y, Cb, Cr block per 8x8 tile,
    // edge-replicated at the right/bottom borders.
    BitWriter bw;
    int preds[3] = {0, 0, 0};
    const int bh = (height + 7) / 8, bwid = (width + 7) / 8;
    for (int by = 0; by < bh; ++by) {
        for (int bx = 0; bx < bwid; ++bx) {
            double chan[3][64];
            for (int yy = 0; yy < 8; ++yy) {
                int sy = by * 8 + yy;
                if (sy >= height) sy = height - 1;
                for (int xx = 0; xx < 8; ++xx) {
                    int sx = bx * 8 + xx;
                    if (sx >= width) sx = width - 1;
                    const uint8_t *p = rgb + 3 * (static_cast<size_t>(sy)
                                                  * width + sx);
                    double r = p[0], g = p[1], b = p[2];
                    chan[0][yy * 8 + xx] =
                        0.299 * r + 0.587 * g + 0.114 * b - 128.0;
                    chan[1][yy * 8 + xx] =
                        -0.168736 * r - 0.331264 * g + 0.5 * b;
                    chan[2][yy * 8 + xx] =
                        0.5 * r - 0.418688 * g - 0.081312 * b;
                }
            }
            for (int c = 0; c < 3; ++c) {
                double coef[64];
                fdct8x8(chan[c], coef);
                const int *q = c == 0 ? ql : qc;
                int zz[64];
                for (int i = 0; i < 64; ++i) {
                    double v = coef[kZigzag[i]] / q[kZigzag[i]];
                    zz[i] = static_cast<int>(std::lround(v));
                }
                encodeBlock(bw, zz, c == 0 ? dcL : dcC,
                            c == 0 ? acL : acC, preds[c]);
            }
        }
    }
    bw.flush();
    out.insert(out.end(), bw.buf.begin(), bw.buf.end());
    byte(0xFF); byte(0xD9);                                   // EOI

    FILE *f = std::fopen(path, "wb");
    if (!f) return 4;
    std::fwrite(out.data(), 1, out.size(), f);
    std::fclose(f);
    return 0;
}

}  // extern "C"
