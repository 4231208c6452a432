// COCO run-length mask codec, C++ implementation.
//
// Replaces pycocotools' C extension (the only native dependency of the
// reference's data layer — SURVEY.md §2 notes its C RLE codec). Masks are
// column-major (Fortran order) uint8 {0,1}; RLE counts alternate runs of
// 0s/1s starting with the 0-run, in the standard COCO layout.
//
// Exposed via a C ABI for ctypes (no pybind11 in this environment).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

extern "C" {

// Encode a column-major mask. counts_out must have capacity h*w+1.
// Returns the number of counts written.
int rle_encode(const uint8_t* mask, int h, int w, uint32_t* counts_out) {
    long n = (long)h * w;
    int m = 0;
    uint8_t cur = 0;  // runs start with zeros
    uint32_t run = 0;
    for (long i = 0; i < n; ++i) {
        uint8_t v = mask[i] ? 1 : 0;
        if (v == cur) {
            ++run;
        } else {
            counts_out[m++] = run;
            cur = v;
            run = 1;
        }
    }
    counts_out[m++] = run;
    return m;
}

// Decode counts into a column-major mask of n = h*w pixels.
void rle_decode(const uint32_t* counts, int m, uint8_t* mask, long n) {
    long i = 0;
    uint8_t v = 0;
    for (int j = 0; j < m && i < n; ++j) {
        uint32_t run = counts[j];
        for (uint32_t r = 0; r < run && i < n; ++r) mask[i++] = v;
        v = 1 - v;
    }
    while (i < n) mask[i++] = 0;
}

unsigned long long rle_area(const uint32_t* counts, int m) {
    unsigned long long a = 0;
    for (int j = 1; j < m; j += 2) a += counts[j];
    return a;
}

// Union of two RLEs over the same h*w grid. out capacity h*w+1.
int rle_merge_or(const uint32_t* a, int ma, const uint32_t* b, int mb,
                 uint32_t* out, long n) {
    // walk both run lists in lockstep
    long ia = 0, ib = 0, pos = 0;
    int ja = 0, jb = 0;
    uint8_t va = 0, vb = 0;
    long enda = ja < ma ? (long)a[0] : n;
    long endb = jb < mb ? (long)b[0] : n;
    int m = 0;
    uint8_t cur = 0;
    uint32_t run = 0;
    while (pos < n) {
        while (pos >= enda && ja + 1 < ma) { va = 1 - va; enda += a[++ja]; }
        while (pos >= endb && jb + 1 < mb) { vb = 1 - vb; endb += b[++jb]; }
        long next = std::min(std::min(enda, endb), n);
        if (next <= pos) next = pos + 1;
        uint8_t v = (va | vb);
        if (v == cur) {
            run += (uint32_t)(next - pos);
        } else {
            out[m++] = run;
            cur = v;
            run = (uint32_t)(next - pos);
        }
        pos = next;
    }
    out[m++] = run;
    return m;
}

// Tight bbox [x, y, w, h] of an RLE (column-major grid).
void rle_to_bbox(const uint32_t* counts, int m, int h, int w, double* bb) {
    long pos = 0;
    long xmin = w, xmax = -1, ymin = h, ymax = -1;
    uint8_t v = 0;
    for (int j = 0; j < m; ++j) {
        long run = counts[j];
        if (v) {
            long s = pos, e = pos + run - 1;
            long xs = s / h, xe = e / h;
            if (xs < xmin) xmin = xs;
            if (xe > xmax) xmax = xe;
            if (xs == xe) {
                long ys = s % h, ye = e % h;
                if (ys < ymin) ymin = ys;
                if (ye > ymax) ymax = ye;
            } else {
                ymin = 0; ymax = h - 1;
            }
        }
        pos += run;
        v = 1 - v;
    }
    if (xmax < 0) { bb[0] = bb[1] = bb[2] = bb[3] = 0; return; }
    bb[0] = (double)xmin; bb[1] = (double)ymin;
    bb[2] = (double)(xmax - xmin + 1); bb[3] = (double)(ymax - ymin + 1);
}

// Polygon -> RLE, following the COCO MaskApi approach: rasterize the polygon
// boundary on a 5x upsampled grid, project vertical crossings back to pixel
// columns, and turn sorted crossing indices into alternating runs (each
// crossing toggles inside/outside along the column-major scan).
int rle_from_poly(const double* xy, int k, int h, int w, uint32_t* counts_out) {
    const double scale = 5.0;
    std::vector<long> x(k + 1), y(k + 1);
    for (int j = 0; j < k; ++j) {
        x[j] = (long)(scale * xy[2 * j + 0] + 0.5);
        y[j] = (long)(scale * xy[2 * j + 1] + 0.5);
    }
    x[k] = x[0]; y[k] = y[0];

    // boundary points on the fine grid
    std::vector<long> u, v;
    u.reserve(8 * k + 8); v.reserve(8 * k + 8);
    for (int j = 0; j < k; ++j) {
        long xs = x[j], xe = x[j + 1], ys = y[j], ye = y[j + 1];
        long dx = std::labs(xe - xs), dy = std::labs(ye - ys);
        bool flip = (dx >= dy && xs > xe) || (dx < dy && ys > ye);
        if (flip) { std::swap(xs, xe); std::swap(ys, ye); }
        if (dx >= dy) {
            double s = dx == 0 ? 0.0 : (double)(ye - ys) / dx;
            for (long d = 0; d <= dx; ++d) {
                long t = flip ? dx - d : d;
                u.push_back(t + xs);
                v.push_back((long)(ys + s * t + 0.5));
            }
        } else {
            double s = dy == 0 ? 0.0 : (double)(xe - xs) / dy;
            for (long d = 0; d <= dy; ++d) {
                long t = flip ? dy - d : d;
                v.push_back(t + ys);
                u.push_back((long)(xs + s * t + 0.5));
            }
        }
    }

    // column-boundary crossings, downsampled to the pixel grid
    std::vector<unsigned long> a;
    a.reserve(u.size());
    for (size_t j = 1; j < u.size(); ++j) {
        if (u[j] == u[j - 1]) continue;
        double xd = (double)std::min(u[j], u[j - 1]);
        xd = (xd + 0.5) / scale - 0.5;
        if (std::floor(xd) != xd || xd < 0 || xd > w - 1) continue;
        double yd = (double)std::min(v[j], v[j - 1]);
        yd = (yd + 0.5) / scale - 0.5;
        if (yd < 0) yd = 0; else if (yd > h) yd = h;
        yd = std::ceil(yd);
        a.push_back((unsigned long)xd * h + (unsigned long)yd);
    }
    std::sort(a.begin(), a.end());

    // Effective toggles: a position crossed an even number of times cancels
    // out entirely (the boundary grazes the column without entering it);
    // odd multiplicity leaves one toggle. For a closed polygon the surviving
    // toggles pair up per column, so parity ends at background.
    long n = (long)h * w;
    std::vector<unsigned long> t;
    t.reserve(a.size());
    for (size_t j = 0; j < a.size();) {
        size_t e = j;
        while (e < a.size() && a[e] == a[j]) ++e;
        if ((e - j) % 2 == 1) t.push_back(a[j]);
        j = e;
    }
    std::vector<uint32_t> c;
    c.reserve(t.size() + 1);
    unsigned long prev = 0;
    for (unsigned long val : t) {
        c.push_back((uint32_t)(val - prev));
        prev = val;
    }
    c.push_back((uint32_t)(n - (long)prev));  // tail run (may be length 0)
    std::memcpy(counts_out, c.data(), c.size() * sizeof(uint32_t));
    return (int)c.size();
}

// COCO compressed-string layer (pycocotools rleFrString/rleToString):
// base-48 5-bit chunks, sign-extended, delta-coded for i > 2.
// returns the count of decoded runs, or -1 if the string is truncated
// (a final character with the continuation bit set — never read past n)
int rle_from_string(const uint8_t* s, long n, uint32_t* counts_out) {
    int m = 0;
    long i = 0;
    while (i < n) {
        long long x = 0;
        int k = 0;
        bool more = true;
        while (more) {
            if (i >= n) return -1;
            int c = (int)s[i] - 48;
            x |= (long long)(c & 0x1F) << (5 * k);
            more = (c & 0x20) != 0;
            i++;
            k++;
            if (!more && (c & 0x10)) x |= -1LL << (5 * k);
        }
        if (m > 2) x += (long long)counts_out[m - 2];
        counts_out[m++] = (uint32_t)x;
    }
    return m;
}

long rle_to_string(const uint32_t* counts, int m, uint8_t* out) {
    long n = 0;
    for (int i = 0; i < m; i++) {
        long long x = (long long)counts[i];
        if (i > 2) x -= (long long)counts[i - 2];
        bool more = true;
        while (more) {
            int chunk = (int)(x & 0x1F);
            x >>= 5;
            more = (chunk & 0x10) ? (x != -1) : (x != 0);
            if (more) chunk |= 0x20;
            out[n++] = (uint8_t)(chunk + 48);
        }
    }
    return n;
}

}  // extern "C"
