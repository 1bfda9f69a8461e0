// Native runtime kernels for ibamr_tpu (host side).
//
// Reference parity: the reference's runtime around the compute path is
// C++ (SURVEY.md §2.5 — IBStandardInitializer file parsing, SILO/VisIt
// writers, Streamable packing). The TPU compute path is JAX/XLA; this
// library is the native equivalent of the reference's HOST runtime:
//
//  * parse_table:   whitespace/comment-tolerant numeric table parser —
//                   the hot loop of .vertex/.spring/.beam/.target
//                   reading (P10). ~30-60x faster than the Python
//                   tokenizer on multi-million-line structure files.
//  * encode_base64: VTK appended-binary payload encoder (T15
//                   replacement's binary mode).
//
// Exposed with a plain C ABI for ctypes (no pybind11 in the image).
// Build: g++ -O3 -march=native -shared -fPIC ibamr_native.cpp -o ...

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

extern "C" {

// Parse up to max_rows rows of whitespace-separated doubles from a
// text buffer. '#' and '//' start comments running to end of line.
// Rows are newline-delimited; columns beyond max_cols are counted in
// ncols_out (true per-row column count) but not stored; short rows are
// padded with NaN. STRICT tokens (matching the Python parser): a token
// must be entirely consumed by strtod and must not be a hex literal —
// otherwise parsing stops and *status reports the offending line
// (1-based). Returns the number of rows parsed; *status == 0 on
// success.
long parse_table(const char* buf, long len, double* out, long max_rows,
                 long max_cols, int* ncols_out, long* status) {
    const char* p = buf;
    const char* end = buf + len;
    long row = 0;
    long line_no = 1;
    *status = 0;
    while (p < end && row < max_rows) {
        long col = 0;
        while (p < end && *p != '\n') {
            while (p < end && (*p == ' ' || *p == '\t' || *p == '\r'))
                ++p;
            if (p >= end || *p == '\n') break;
            if (*p == '#' || (*p == '/' && p + 1 < end && p[1] == '/')) {
                while (p < end && *p != '\n') ++p;
                break;
            }
            // token extent: up to whitespace / comment / EOL
            const char* q = p;
            while (q < end && *q != ' ' && *q != '\t' && *q != '\n'
                   && *q != '\r' && *q != '#')
                ++q;
            bool hex = false;
            for (const char* c = p; c < q; ++c)
                if (*c == 'x' || *c == 'X') hex = true;
            char* next = nullptr;
            double v = strtod(p, &next);
            if (next != q || hex) {     // partial/invalid token: error
                *status = line_no;
                return row;
            }
            if (col < max_cols) out[row * max_cols + col] = v;
            ++col;
            p = next;
        }
        if (p < end && *p == '\n') {
            ++p;
            ++line_no;
        }
        if (col > 0) {
            for (long c = col; c < max_cols; ++c)
                out[row * max_cols + c] = __builtin_nan("");
            ncols_out[row] = (int)col;  // TRUE count (may exceed max)
            ++row;
        }
    }
    return row;
}

// Standard base64 (RFC 4648) of a binary buffer; returns encoded size.
// out must hold 4 * ((n + 2) / 3) bytes.
long encode_base64(const uint8_t* in, long n, char* out) {
    static const char tab[] =
        "ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";
    long o = 0;
    long i = 0;
    for (; i + 2 < n; i += 3) {
        uint32_t v = (in[i] << 16) | (in[i + 1] << 8) | in[i + 2];
        out[o++] = tab[(v >> 18) & 63];
        out[o++] = tab[(v >> 12) & 63];
        out[o++] = tab[(v >> 6) & 63];
        out[o++] = tab[v & 63];
    }
    if (i < n) {
        uint32_t v = in[i] << 16;
        int rem = (int)(n - i);
        if (rem == 2) v |= in[i + 1] << 8;
        out[o++] = tab[(v >> 18) & 63];
        out[o++] = tab[(v >> 12) & 63];
        out[o++] = rem == 2 ? tab[(v >> 6) & 63] : '=';
        out[o++] = '=';
    }
    return o;
}

int ibamr_native_abi_version() { return 2; }

}  // extern "C"
