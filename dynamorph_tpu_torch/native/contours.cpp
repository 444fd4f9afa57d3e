// Contour tracing and the minimum-area rectangle of a binary mask, with the
// results of OpenCV's findContours(mask, RETR_LIST, CHAIN_APPROX_SIMPLE)
// and minAreaRect.
//
// Native backend for dynamorph_tpu_torch/native/contours.py, which serves
// the long-axis patch extraction (pipeline/patch.py::get_cell_rect_angle)
// and the morphology features (analysis/morphology.py).
//
// Exposed as a C ABI for ctypes:
//   void* contours_trace(const uint8_t* mask, int h, int w)
//   int   contours_count(void* handle)       number of contours
//   int   contours_total(void* handle)       number of points in all
//   void  contours_copy(void* handle, int32_t* xy, int32_t* lengths)
//   void  contours_free(void* handle)
//   int   min_area_rect(const int32_t* xy, int n, float* out5)
//         out5 = (centre x, centre y, width, height, angle in degrees)
//
// Built by dynamorph_tpu_torch/native/__init__.py:
//   g++ -O3 -shared -fPIC -pthread -o build/native/libcontours-<hash>.so
//
// Tracing is Suzuki & Abe's border following ("Topological structural
// analysis of digitized binary images by border following", CVGIP 30,
// 1985) as OpenCV runs it: the mask padded by one zero pixel, raster scan,
// outer borders where a 0 is followed by a 1, hole borders where an
// unmarked or positively marked 1 is followed by a 0, a traced pixel
// marked 2 (or -126 where the border leaves it to its right), and a
// point kept only where the chain code turns. The list comes out newest
// first, as OpenCV links each new contour in front of the last.
//
// The rectangle is the rotating-calipers search over the convex hull
// (Sklansky's scan on the points sorted by x, then y), in float32 with
// OpenCV's operation order. The angle is brought into [-90, 0) degrees,
// the sides swapped at each quarter turn, as OpenCV 5.0 reports it.

#pragma GCC optimize("fp-contract=off")

#include <algorithm>
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <utility>
#include <vector>

namespace {

struct Point { int x, y; };

struct Contours {
    std::vector<std::vector<Point>> list;   // in discovery order
};

// chain-code steps 0..7: E, NE, N, NW, W, SW, S, SE (y grows downwards)
const int kDX[8] = {1, 1, 0, -1, -1, -1, 0, 1};
const int kDY[8] = {0, -1, -1, -1, 0, 1, 1, 1};

void fetch_contour(int8_t* img, long step, long start, Point pt,
                   bool is_hole, std::vector<Point>& out) {
    const int8_t nbd = 2;
    const int8_t right_mark = (int8_t)(nbd | -128);
    long deltas[16];
    for (int k = 0; k < 8; ++k) deltas[k] = deltas[k + 8] = kDY[k] * step + kDX[k];

    long i0 = start, i1 = 0, i3, i4 = 0;
    int s = is_hole ? 0 : 4;
    int s_end = s;
    do {
        s = (s - 1) & 7;
        i1 = i0 + deltas[s];
    } while (img[i1] == 0 && s != s_end);

    if (s == s_end) {            // a single-pixel component
        img[i0] = right_mark;
        out.push_back(pt);
        return;
    }
    i3 = i0;
    int prev_s = s ^ 4;
    for (;;) {
        s_end = s;
        s = std::min(s, 15);
        while (s < 15) {
            i4 = i3 + deltas[++s];
            if (img[i4] != 0) break;
        }
        s &= 7;
        if ((unsigned)(s - 1) < (unsigned)s_end) {
            img[i3] = right_mark;
        } else if (img[i3] == 1) {
            img[i3] = nbd;
        }
        if (s != prev_s) {
            out.push_back(pt);
            prev_s = s;
        }
        pt.x += kDX[s];
        pt.y += kDY[s];
        if (i4 == i0 && i3 == i1) break;
        i3 = i4;
        s = (s + 4) & 7;
    }
}

void trace(const uint8_t* mask, int h, int w, Contours& c) {
    const long step = w + 2;
    std::vector<int8_t> buf((size_t)(h + 2) * step, 0);
    for (int y = 0; y < h; ++y)
        for (int x = 0; x < w; ++x)
            buf[(size_t)(y + 1) * step + x + 1] = mask[(size_t)y * w + x] != 0;
    int8_t* img = buf.data();
    const int width = w + 1, height = h + 1;
    for (int y = 1; y < height; ++y) {
        int8_t* row = img + (long)y * step;
        int prev = 0;
        for (int x = 1; x < width; ++x) {
            int p = row[x];
            if (p == prev) continue;
            bool is_hole = false;
            if (!(prev == 0 && p == 1)) {
                if (p != 0 || prev < 1) {
                    prev = p;
                    continue;
                }
                is_hole = true;
            }
            Point origin = {x - (int)is_hole - 1, y - 1};
            c.list.emplace_back();
            fetch_contour(img, step, (long)y * step + x - (int)is_hole,
                          origin, is_hole, c.list.back());
            // the scan resumes after the start, reading it as it is now
            prev = row[x];
        }
    }
}

// --- convex hull (Sklansky), as cv::convexHull(points, hull, false, true)

bool less_point(const Point* a, const Point* b) {
    if (a->x != b->x) return a->x < b->x;
    if (a->y != b->y) return a->y < b->y;
    return a < b;
}

int sign(long v) { return (v > 0) - (v < 0); }

int sklansky(Point** array, int start, int end, int* stack, int nsign,
             int sign2) {
    int incr = end > start ? 1 : -1;
    int pprev = start, pcur = pprev + incr, pnext = pcur + incr;
    int stacksize = 3;
    if (start == end || (array[start]->x == array[end]->x &&
                         array[start]->y == array[end]->y)) {
        stack[0] = start;
        return 1;
    }
    stack[0] = pprev;
    stack[1] = pcur;
    stack[2] = pnext;
    end += incr;
    while (pnext != end) {
        long cury = array[pcur]->y;
        long nexty = array[pnext]->y;
        long by = nexty - cury;
        if (sign(by) != nsign) {
            long ax = array[pcur]->x - array[pprev]->x;
            long bx = array[pnext]->x - array[pcur]->x;
            long ay = cury - array[pprev]->y;
            long convexity = ay * bx - ax * by;
            if (sign(convexity) == sign2 && (ax != 0 || ay != 0)) {
                pprev = pcur;
                pcur = pnext;
                pnext += incr;
                stack[stacksize] = pnext;
                stacksize++;
            } else if (pprev == start) {
                pcur = pnext;
                stack[1] = pcur;
                pnext += incr;
                stack[2] = pnext;
            } else {
                stack[stacksize - 2] = pnext;
                pcur = pprev;
                pprev = stack[stacksize - 4];
                stacksize--;
            }
        } else {
            pnext += incr;
            stack[stacksize - 1] = pnext;
        }
    }
    return --stacksize;
}

std::vector<Point> convex_hull(const Point* data0, int total) {
    std::vector<Point*> pointer(total);
    std::vector<int> stack(total + 2), hullbuf(total);
    for (int i = 0; i < total; ++i) pointer[i] = const_cast<Point*>(&data0[i]);
    std::sort(pointer.begin(), pointer.end(), less_point);
    int miny_ind = 0, maxy_ind = 0;
    for (int i = 1; i < total; ++i) {
        int y = pointer[i]->y;
        if (pointer[miny_ind]->y > y) miny_ind = i;
        if (pointer[maxy_ind]->y < y) maxy_ind = i;
    }
    int nout = 0;
    Point** ptr = pointer.data();
    if (pointer[0]->x == pointer[total - 1]->x &&
        pointer[0]->y == pointer[total - 1]->y) {
        hullbuf[nout++] = 0;
    } else {
        int* tl_stack = stack.data();
        int tl_count = sklansky(ptr, 0, maxy_ind, tl_stack, -1, 1);
        int* tr_stack = stack.data() + tl_count;
        int tr_count = sklansky(ptr, total - 1, maxy_ind, tr_stack, -1, -1);
        // counter-clockwise (clockwise=false)
        std::swap(tl_stack, tr_stack);
        std::swap(tl_count, tr_count);
        for (int i = 0; i < tl_count - 1; ++i)
            hullbuf[nout++] = (int)(pointer[tl_stack[i]] - data0);
        for (int i = tr_count - 1; i > 0; --i)
            hullbuf[nout++] = (int)(pointer[tr_stack[i]] - data0);
        int stop_idx = tr_count > 2 ? tr_stack[1]
                     : tl_count > 2 ? tl_stack[tl_count - 2] : -1;

        int* bl_stack = stack.data();
        int bl_count = sklansky(ptr, 0, miny_ind, bl_stack, 1, -1);
        int* br_stack = stack.data() + bl_count;
        int br_count = sklansky(ptr, total - 1, miny_ind, br_stack, 1, 1);
        if (stop_idx >= 0) {
            int check_idx = bl_count > 2 ? bl_stack[1]
                          : bl_count + br_count > 2 ? br_stack[2 - bl_count]
                          : -1;
            if (check_idx == stop_idx ||
                (check_idx >= 0 &&
                 pointer[check_idx]->x == pointer[stop_idx]->x &&
                 pointer[check_idx]->y == pointer[stop_idx]->y)) {
                // all points on one line: the lower half mirrors the upper
                bl_count = std::min(bl_count, 2);
                br_count = std::min(br_count, 2);
            }
        }
        for (int i = 0; i < bl_count - 1; ++i)
            hullbuf[nout++] = (int)(pointer[bl_stack[i]] - data0);
        for (int i = br_count - 1; i > 0; --i)
            hullbuf[nout++] = (int)(pointer[br_stack[i]] - data0);

        // cyclic shift so the indices ascend or descend where they can
        if (nout >= 3) {
            int min_idx = 0, max_idx = 0, lt = 0;
            for (int i = 1; i < nout; ++i) {
                int idx = hullbuf[i];
                lt += hullbuf[i - 1] < idx;
                if (lt > 1 && lt <= i - 2) break;
                if (idx < hullbuf[min_idx]) min_idx = i;
                if (idx > hullbuf[max_idx]) max_idx = i;
            }
            int mmdist = std::abs(max_idx - min_idx);
            if ((mmdist == 1 || mmdist == nout - 1) &&
                (lt <= 1 || lt >= nout - 2)) {
                int ascending = (max_idx + 1) % nout == min_idx;
                int i0 = ascending ? min_idx : max_idx, j = i0;
                if (i0 > 0) {
                    int i;
                    for (i = 0; i < nout; ++i) {
                        int curr_idx = stack[i] = hullbuf[j];
                        int next_j = j + 1 < nout ? j + 1 : 0;
                        int next_idx = hullbuf[next_j];
                        if (i < nout - 1 && (ascending != (curr_idx < next_idx)))
                            break;
                        j = next_j;
                    }
                    if (i == nout)
                        std::memcpy(hullbuf.data(), stack.data(),
                                    nout * sizeof(int));
                }
            }
        }
    }
    std::vector<Point> hull(nout);
    for (int i = 0; i < nout; ++i) hull[i] = data0[hullbuf[i]];
    return hull;
}

struct P2f { float x, y; };

// rotating calipers, minimum-area mode; out = corner, side 1, side 2
void rotating_calipers(const P2f* points, int n, float* out) {
    float minarea = FLT_MAX;
    float buf[7] = {0};
    int buf_i0 = 0, buf_i5 = 0;
    std::vector<float> inv_vect_length(n);
    std::vector<P2f> vect(n);
    int left = 0, bottom = 0, right = 0, top = 0;
    int seq[4] = {-1, -1, -1, -1};
    float orientation = 0;
    float base_a;
    float base_b = 0;
    float left_x, right_x, top_y, bottom_y;
    P2f pt0 = points[0];
    left_x = right_x = pt0.x;
    top_y = bottom_y = pt0.y;
    for (int i = 0; i < n; ++i) {
        if (pt0.x < left_x) left_x = pt0.x, left = i;
        if (pt0.x > right_x) right_x = pt0.x, right = i;
        if (pt0.y > top_y) top_y = pt0.y, top = i;
        if (pt0.y < bottom_y) bottom_y = pt0.y, bottom = i;
        P2f pt = points[(i + 1) & (i + 1 < n ? -1 : 0)];
        double dx = pt.x - pt0.x;
        double dy = pt.y - pt0.y;
        vect[i].x = (float)dx;
        vect[i].y = (float)dy;
        inv_vect_length[i] = (float)(1. / std::sqrt(dx * dx + dy * dy));
        pt0 = pt;
    }
    {
        double ax = vect[n - 1].x;
        double ay = vect[n - 1].y;
        for (int i = 0; i < n; ++i) {
            double bx = vect[i].x;
            double by = vect[i].y;
            double convexity = ax * by - ay * bx;
            if (convexity != 0) {
                orientation = (convexity > 0) ? 1.f : (-1.f);
                break;
            }
            ax = bx;
            ay = by;
        }
    }
    base_a = orientation;
    seq[0] = bottom;
    seq[1] = right;
    seq[2] = top;
    seq[3] = left;
    for (int k = 0; k < n; ++k) {
        float dp[4] = {
            +base_a * vect[seq[0]].x + base_b * vect[seq[0]].y,
            -base_b * vect[seq[1]].x + base_a * vect[seq[1]].y,
            -base_a * vect[seq[2]].x - base_b * vect[seq[2]].y,
            +base_b * vect[seq[3]].x - base_a * vect[seq[3]].y,
        };
        float maxcos = dp[0] * inv_vect_length[seq[0]];
        int main_element = 0;
        for (int i = 1; i < 4; ++i) {
            float cosalpha = dp[i] * inv_vect_length[seq[i]];
            if (cosalpha > maxcos) {
                main_element = i;
                maxcos = cosalpha;
            }
        }
        {
            int pindex = seq[main_element];
            float lead_x = vect[pindex].x * inv_vect_length[pindex];
            float lead_y = vect[pindex].y * inv_vect_length[pindex];
            switch (main_element) {
            case 0: base_a = lead_x; base_b = lead_y; break;
            case 1: base_a = lead_y; base_b = -lead_x; break;
            case 2: base_a = -lead_x; base_b = -lead_y; break;
            default: base_a = -lead_y; base_b = lead_x; break;
            }
        }
        seq[main_element] += 1;
        seq[main_element] = (seq[main_element] == n) ? 0 : seq[main_element];
        {
            float dx = points[seq[1]].x - points[seq[3]].x;
            float dy = points[seq[1]].y - points[seq[3]].y;
            float width = dx * base_a + dy * base_b;
            dx = points[seq[2]].x - points[seq[0]].x;
            dy = points[seq[2]].y - points[seq[0]].y;
            float height = -dx * base_b + dy * base_a;
            float area = width * height;
            if (area <= minarea) {
                minarea = area;
                buf_i0 = seq[3];
                buf[1] = base_a;
                buf[2] = width;
                buf[3] = base_b;
                buf[4] = height;
                buf_i5 = seq[0];
                buf[6] = area;
            }
        }
    }
    float A1 = buf[1];
    float B1 = buf[3];
    float A2 = -buf[3];
    float B2 = buf[1];
    float C1 = A1 * points[buf_i0].x + points[buf_i0].y * B1;
    float C2 = A2 * points[buf_i5].x + points[buf_i5].y * B2;
    float idet = 1.f / (A1 * B2 - A2 * B1);
    float px = (C1 * B2 - C2 * B1) * idet;
    float py = (A1 * C2 - A2 * C1) * idet;
    out[0] = px;
    out[1] = py;
    out[2] = A1 * buf[2];
    out[3] = B1 * buf[2];
    out[4] = A2 * buf[4];
    out[5] = B2 * buf[4];
}

}  // namespace

extern "C" {

void* contours_trace(const uint8_t* mask, int h, int w) {
    Contours* c = new Contours();
    if (h > 0 && w > 0) trace(mask, h, w, *c);
    return c;
}

int contours_count(void* handle) {
    return (int)static_cast<Contours*>(handle)->list.size();
}

int contours_total(void* handle) {
    long total = 0;
    for (const auto& v : static_cast<Contours*>(handle)->list) total += v.size();
    return (int)total;
}

// newest contour first, each as its (x, y) points in tracing order
void contours_copy(void* handle, int32_t* xy, int32_t* lengths) {
    const auto& list = static_cast<Contours*>(handle)->list;
    long k = 0;
    int n = (int)list.size();
    for (int i = 0; i < n; ++i) {
        const auto& v = list[n - 1 - i];
        lengths[i] = (int32_t)v.size();
        for (const Point& p : v) {
            xy[2 * k] = p.x;
            xy[2 * k + 1] = p.y;
            ++k;
        }
    }
}

void contours_free(void* handle) { delete static_cast<Contours*>(handle); }

int min_area_rect(const int32_t* xy, int n, float* out5) {
    if (n <= 0) return 1;
    std::vector<Point> pts(n);
    for (int i = 0; i < n; ++i) pts[i] = {xy[2 * i], xy[2 * i + 1]};
    std::vector<Point> hull = convex_hull(pts.data(), n);
    int m = (int)hull.size();
    std::vector<P2f> hp(m);
    for (int i = 0; i < m; ++i) hp[i] = {(float)hull[i].x, (float)hull[i].y};
    float cx = 0, cy = 0, width = 0, height = 0;
    double angle = 0;
    if (m > 2) {
        float out[6];
        rotating_calipers(hp.data(), m, out);
        cx = out[0] + (out[2] + out[4]) * 0.5f;
        cy = out[1] + (out[3] + out[5]) * 0.5f;
        width = (float)std::sqrt((double)out[2] * out[2] + (double)out[3] * out[3]);
        height = (float)std::sqrt((double)out[4] * out[4] + (double)out[5] * out[5]);
        angle = std::atan2((double)out[3], (double)out[2]);
    } else if (m == 2) {
        cx = (hp[0].x + hp[1].x) * 0.5f;
        cy = (hp[0].y + hp[1].y) * 0.5f;
        double dx = hp[1].x - hp[0].x;
        double dy = hp[1].y - hp[0].y;
        width = (float)std::sqrt(dx * dx + dy * dy);
        height = 0;
        angle = std::atan2(dy, dx);
    } else {
        cx = hp[0].x;
        cy = hp[0].y;
    }
    // the installed OpenCV reports angles in [-90, 0): each quarter turn
    // into that range swaps the sides
    angle = angle * 180 / M_PI;
    while (angle >= 0) {
        angle -= 90;
        std::swap(width, height);
    }
    while (angle < -90) {
        angle += 90;
        std::swap(width, height);
    }
    out5[0] = cx;
    out5[1] = cy;
    out5[2] = width;
    out5[3] = height;
    out5[4] = (float)angle;
    return 0;
}

}  // extern "C"
