// The port's host library: rectangle grouping, the .vec codec and the
// negative-window miner, in C++17 with the standard library alone.
//
// A C ABI loaded with ctypes by data/native.py and detect/grouping.py;
// _build.py compiles it with g++ at first use. The numpy versions
// (detect/grouping.py, data/vec.py, data/negreader.py) are its plain
// versions, and the tests hold the two byte for byte.
//
// The miner keeps the reference NegReader's schedule
// (imagestorage.cpp:23-126). Decoding stays in Python: the miner asks a
// callback for each background's pixels (data/negreader.py::imread_gray),
// and resizes with the fixed-point INTER_LINEAR_EXACT arithmetic of
// ops/resize.py.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <fstream>
#include <string>
#include <vector>

extern "C" {

// ---------------------------------------------------------------- vec IO

struct VecHandle {
    std::vector<uint8_t> samples;  // count * vecsize decoded u8
    int count = 0;
    int vecsize = 0;
};

void* cctpu_vec_open(const char* path, int* count, int* vecsize) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    int32_t cnt = 0, vs = 0;
    int16_t t1, t2;
    if (fread(&cnt, 4, 1, f) != 1 || fread(&vs, 4, 1, f) != 1 ||
        fread(&t1, 2, 1, f) != 1 || fread(&t2, 2, 1, f) != 1) {
        fclose(f);
        return nullptr;
    }
    // a header whose records the file cannot hold is unreadable: fail
    // before allocating for it
    long here = ftell(f);
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, here, SEEK_SET);
    if (cnt < 0 || vs < 0 ||
        (int64_t)cnt * (1 + 2 * (int64_t)vs) > (int64_t)(size - here)) {
        fclose(f);
        return nullptr;
    }
    auto* h = new VecHandle();
    h->count = cnt;
    h->vecsize = vs;
    h->samples.resize((size_t)cnt * vs);
    std::vector<int16_t> rec(vs);
    for (int i = 0; i < cnt; i++) {
        uint8_t pad;
        if (fread(&pad, 1, 1, f) != 1 ||
            fread(rec.data(), 2, vs, f) != (size_t)vs) {
            fclose(f);
            delete h;
            return nullptr;
        }
        uint8_t* dst = h->samples.data() + (size_t)i * vs;
        for (int j = 0; j < vs; j++) dst[j] = (uint8_t)rec[j];
    }
    fclose(f);
    *count = cnt;
    *vecsize = vs;
    return h;
}

int cctpu_vec_read(void* handle, int start, int n, uint8_t* out) {
    auto* h = (VecHandle*)handle;
    if (!h || start < 0 || start >= h->count) return 0;
    int m = std::min(n, h->count - start);
    memcpy(out, h->samples.data() + (size_t)start * h->vecsize,
           (size_t)m * h->vecsize);
    return m;
}

void cctpu_vec_close(void* handle) { delete (VecHandle*)handle; }

int cctpu_vec_write(const char* path, const uint8_t* data, int count,
                    int vecsize) {
    FILE* f = fopen(path, "wb");
    if (!f) return 0;
    int32_t cnt = count, vs = vecsize;
    int16_t zero = 0;
    fwrite(&cnt, 4, 1, f);
    fwrite(&vs, 4, 1, f);
    fwrite(&zero, 2, 1, f);
    fwrite(&zero, 2, 1, f);
    std::vector<int16_t> rec(vecsize);
    for (int i = 0; i < count; i++) {
        uint8_t pad = 0;
        fwrite(&pad, 1, 1, f);
        const uint8_t* src = data + (size_t)i * vecsize;
        for (int j = 0; j < vecsize; j++) rec[j] = src[j];
        fwrite(rec.data(), 2, vecsize, f);
    }
    return fclose(f) == 0 ? count : 0;
}

// ------------------------------------------------- negative window miner

// The pixels of the background at path: status 1 and a row-major
// (*rows, *cols) uint8 image at *data, valid until the next call; 0 when
// the file cannot be read; 2 for an image of another layout (counted in
// the schedule, then skipped); a negative status stops the miner.
typedef int (*cctpu_imread_fn)(const char* path, const uint8_t** data,
                               int* rows, int* cols);

struct Image {
    std::vector<uint8_t> px;
    int rows = 0, cols = 0;
    bool empty() const { return px.empty(); }
    const uint8_t* ptr(int r) const { return px.data() + (size_t)r * cols; }
};

// One axis of INTER_LINEAR_EXACT (ops/resize.py::_axis_tab): source
// position (d + 0.5)·ssz/dsz − 0.5 as an exact rational, clamped at the
// borders, 8-bit coefficient rounded half to even.
static void axis_tab(int ssz, int dsz, std::vector<int>& sx,
                     std::vector<int>& coef) {
    sx.resize(dsz);
    coef.resize(dsz);
    const int64_t two = 2 * (int64_t)dsz;
    for (int d = 0; d < dsz; d++) {
        int64_t num = (2 * (int64_t)d + 1) * ssz - dsz;  // fx · 2·dsz
        int64_t s = num >= 0 ? num / two : -((-num + two - 1) / two);  // floor
        int64_t rem = num - s * two;
        int64_t a = 128 * rem;  // frac · 256 · dsz
        int64_t q = a / dsz, r = a - q * dsz;
        int64_t c = q + ((2 * r > dsz || (2 * r == dsz && (q & 1))) ? 1 : 0);
        if (s < 0) {
            s = 0;
            c = 0;
        }
        if (s >= ssz - 1) {
            if (ssz > 1) {
                s = ssz - 2;
                c = 256;
            } else {
                s = 0;
                c = 0;
            }
        }
        sx[d] = (int)s;
        coef[d] = (int)c;
    }
}

// ops/resize.py::resize_linear_exact_np: separable integer passes, then
// (v + 2^15) >> 16 saturated to 255.
static void resize_linear_exact(const Image& src, int dw, int dh, Image& dst) {
    dst.rows = dh;
    dst.cols = dw;
    if (src.rows == dh && src.cols == dw) {
        dst.px = src.px;
        return;
    }
    std::vector<int> sxs, cxs, sys, cys;
    axis_tab(src.cols, dw, sxs, cxs);
    axis_tab(src.rows, dh, sys, cys);
    std::vector<uint32_t> hrow((size_t)src.rows * dw);
    for (int y = 0; y < src.rows; y++) {
        const uint8_t* p = src.ptr(y);
        uint32_t* o = hrow.data() + (size_t)y * dw;
        for (int x = 0; x < dw; x++) {
            int x0 = sxs[x], x1 = std::min(x0 + 1, src.cols - 1);
            o[x] = (uint32_t)(256 - cxs[x]) * p[x0] + (uint32_t)cxs[x] * p[x1];
        }
    }
    dst.px.resize((size_t)dh * dw);
    for (int y = 0; y < dh; y++) {
        int y0 = sys[y], y1 = std::min(y0 + 1, src.rows - 1);
        const uint32_t* h0 = hrow.data() + (size_t)y0 * dw;
        const uint32_t* h1 = hrow.data() + (size_t)y1 * dw;
        uint8_t* o = dst.px.data() + (size_t)y * dw;
        uint32_t wy0 = 256 - cys[y], wy1 = cys[y];
        for (int x = 0; x < dw; x++) {
            uint32_t v = wy0 * h0[x] + wy1 * h1[x];
            o[x] = (uint8_t)std::min<uint32_t>((v + (1u << 15)) >> 16, 255);
        }
    }
}

struct NegHandle {
    std::vector<std::string> files;
    cctpu_imread_fn imread = nullptr;
    int win_w = 0, win_h = 0;
    Image src, img;
    int point_x = 0, point_y = 0, offset_x = 0, offset_y = 0;
    float scale = 1.0f;
    const float scale_factor = 1.4142135623730950488016887242097f;
    const float step_factor = 0.5f;
    size_t last = 0;
    int round = 0;
    bool failed = false;  // the callback reported an error

    // 1 and the image in s, 0 when unreadable, 2 for another layout
    int read(const std::string& path, Image& s) {
        const uint8_t* data = nullptr;
        int rows = 0, cols = 0;
        int st = imread(path.c_str(), &data, &rows, &cols);
        if (st < 0) failed = true;
        if (st <= 0 || rows <= 0 || cols <= 0) return 0;
        s.rows = rows;
        s.cols = cols;
        if (st == 1) s.px.assign(data, data + (size_t)rows * cols);
        return st;
    }

    bool next_img() {
        size_t count = files.size();
        int off_x = 0, off_y = 0;
        Image s;
        bool found = false;
        for (size_t i = 0; i < count; i++) {
            int st = read(files[last++], s);
            if (failed) return false;
            if (st == 0) {
                last %= count;
                continue;
            }
            round += (int)(last / count);
            round %= win_w * win_h;
            last %= count;
            off_x = std::min(round % win_w, s.cols - win_w);
            off_y = std::min(round / win_w, s.rows - win_h);
            if (st == 1 && off_x >= 0 && off_y >= 0) {
                found = true;
                break;
            }
        }
        if (!found) return false;
        src = std::move(s);
        point_x = offset_x = off_x;
        point_y = offset_y = off_y;
        scale = std::max(((float)win_w + off_x) / src.cols,
                         ((float)win_h + off_y) / src.rows);
        resize_linear_exact(src, (int)(scale * src.cols + 0.5f),
                            (int)(scale * src.rows + 0.5f), img);
        return true;
    }

    bool get(uint8_t* out) {
        if (img.empty() && !next_img()) return false;
        for (int r = 0; r < win_h; r++)
            memcpy(out + (size_t)r * win_w, img.ptr(point_y + r) + point_x,
                   win_w);
        if ((int)(point_x + (1.0f + step_factor) * win_w) < img.cols) {
            point_x += (int)(step_factor * win_w);
        } else {
            point_x = offset_x;
            if ((int)(point_y + (1.0f + step_factor) * win_h) < img.rows) {
                point_y += (int)(step_factor * win_h);
            } else {
                point_y = offset_y;
                scale *= scale_factor;
                if (scale <= 1.0f) {
                    resize_linear_exact(src, (int)(scale * src.cols),
                                        (int)(scale * src.rows), img);
                } else {
                    if (!next_img()) return false;
                }
            }
        }
        return true;
    }
};

void* cctpu_neg_open(const char* bg_path, int win_w, int win_h,
                     cctpu_imread_fn imread) {
    std::ifstream f(bg_path);
    if (!f.is_open() || !imread || win_w <= 0 || win_h <= 0) return nullptr;
    auto* h = new NegHandle();
    h->win_w = win_w;
    h->win_h = win_h;
    h->imread = imread;
    std::string line;
    while (std::getline(f, line)) {
        size_t end = line.find_last_not_of(" \n\r\t");
        if (end == std::string::npos) break;  // empty line terminates
        line.erase(end + 1);
        if (line[0] == '#') continue;
        h->files.push_back(line);
    }
    if (h->files.empty()) {
        delete h;
        return nullptr;
    }
    return h;
}

// fills up to n windows (n * win_h * win_w bytes); returns how many, or
// -1 when the image callback reported an error
int cctpu_neg_next(void* handle, uint8_t* out, int n) {
    auto* h = (NegHandle*)handle;
    if (!h) return 0;
    int filled = 0;
    size_t stride = (size_t)h->win_w * h->win_h;
    for (int i = 0; i < n; i++) {
        if (!h->get(out + (size_t)filled * stride)) break;
        filled++;
    }
    return h->failed ? -1 : filled;
}

void cctpu_neg_close(void* handle) { delete (NegHandle*)handle; }

// ------------------------------------------------ rectangle grouping
// Exact cv::groupRectangles semantics (see detect/grouping.py for the
// specification): an all-pairs union-find, classes numbered by their
// first member, float averages rounded half to even, the containment
// filter. O(N^2): detect/grouping.py sends it at most NATIVE_MAX rects.

int cctpu_group_rectangles(const int32_t* rects_in, int n,
                           int group_threshold, double eps,
                           int32_t* rects_out /* cap n*4 */) {
    if (group_threshold <= 0 || n == 0) {
        memcpy(rects_out, rects_in, (size_t)n * 4 * sizeof(int32_t));
        return n;
    }
    std::vector<int> parent(n);
    for (int i = 0; i < n; i++) parent[i] = i;
    auto find = [&](int a) {
        while (parent[a] != a) {
            parent[a] = parent[parent[a]];
            a = parent[a];
        }
        return a;
    };
    auto similar = [&](int i, int j) {
        const int32_t* r1 = rects_in + (size_t)i * 4;
        const int32_t* r2 = rects_in + (size_t)j * 4;
        double delta =
            eps * (std::min(r1[2], r2[2]) + std::min(r1[3], r2[3])) * 0.5;
        return std::abs(r1[0] - r2[0]) <= delta &&
               std::abs(r1[1] - r2[1]) <= delta &&
               std::abs(r1[0] + r1[2] - r2[0] - r2[2]) <= delta &&
               std::abs(r1[1] + r1[3] - r2[1] - r2[3]) <= delta;
    };
    for (int i = 0; i < n; i++)
        for (int j = i + 1; j < n; j++)
            if (similar(i, j)) {
                int ri = find(i), rj = find(j);
                if (ri != rj) parent[rj] = ri;
            }

    std::vector<int> root(n), cls(n, -1);
    int nclasses = 0;
    for (int i = 0; i < n; i++) root[i] = find(i);
    for (int i = 0; i < n; i++)  // class id by first appearance
        if (cls[root[i]] < 0) cls[root[i]] = nclasses++;
    std::vector<int64_t> acc(4 * (size_t)nclasses, 0);
    std::vector<int> cnt(nclasses, 0);
    for (int i = 0; i < n; i++) {
        int c = cls[root[i]];
        for (int k = 0; k < 4; k++) acc[4 * (size_t)c + k] += rects_in[4 * (size_t)i + k];
        cnt[c]++;
    }
    auto cvround = [](double v) { return (int)lrint(v); };
    // OpenCV averages with float s = 1.f/n and FLOAT products
    // (cascadedetect.cpp groupRectangles): the single-precision
    // arithmetic, for byte parity
    std::vector<int> rr(4 * (size_t)nclasses);
    for (int c = 0; c < nclasses; c++) {
        float s = 1.0f / (float)cnt[c];
        for (int k = 0; k < 4; k++)
            rr[4 * (size_t)c + k] =
                (int)lrintf((float)acc[4 * (size_t)c + k] * s);
    }
    int out = 0;
    for (int i = 0; i < nclasses; i++) {
        int n1 = cnt[i];
        if (n1 <= group_threshold) continue;
        bool contained = false;
        for (int j = 0; j < nclasses; j++) {
            int n2 = cnt[j];
            if (j == i || n2 <= group_threshold) continue;
            const int* r1 = &rr[4 * (size_t)i];
            const int* r2 = &rr[4 * (size_t)j];
            int dx = cvround(r2[2] * eps);
            int dy = cvround(r2[3] * eps);
            if (r1[0] >= r2[0] - dx && r1[1] >= r2[1] - dy &&
                r1[0] + r1[2] <= r2[0] + r2[2] + dx &&
                r1[1] + r1[3] <= r2[1] + r2[3] + dy &&
                (n2 > std::max(3, n1) || n1 < 3)) {
                contained = true;
                break;
            }
        }
        if (!contained) {
            memcpy(rects_out + (size_t)out * 4, &rr[4 * (size_t)i],
                   4 * sizeof(int32_t));
            out++;
        }
    }
    return out;
}

}  // extern "C"
