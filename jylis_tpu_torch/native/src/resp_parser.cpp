// Native RESP command scanner — the hot per-request parse loop.
//
// The rebuild's [native codec] component for the client API layer
// (SURVEY.md section 2.4: the reference delegates this to pony-resp's
// CommandParser, compiled Pony — a Python loop is not an equivalent).
// Semantics mirror jylis_tpu/server/resp.py exactly; that module stays the
// always-available fallback and this scanner's differential-test oracle.
//
// C ABI, ctypes-friendly: scan ONE command from the head of `buf`.
// Returns:
//   1  command parsed: *consumed = bytes to discard, offs/lens filled with
//      *n_args argument slices (offsets into buf)
//   0  incomplete — feed more bytes
//  -1  protocol error (connection should be dropped)
//  -2  more than max_args arguments: *n_args = required capacity; rescan
//      with bigger arrays
//
// Inline commands (no leading '*') may legally parse to zero args (blank
// line): returns 1 with *n_args = 0; callers skip and continue.

#include <cstdint>
#include <cstring>

namespace {

constexpr int64_t MAX_LINE = 64 * 1024;
constexpr int64_t MAX_BULK = 512LL * 1024 * 1024;  // Redis proto-max-bulk-len
constexpr int64_t MAX_ARRAY = 1024 * 1024;

// find "\r\n" starting at `start`; returns end-of-line index or -1
int64_t find_crlf(const uint8_t* buf, int64_t len, int64_t start) {
    const void* p = memchr(buf + start, '\r', static_cast<size_t>(len - start));
    while (p != nullptr) {
        int64_t i = static_cast<const uint8_t*>(p) - buf;
        if (i + 1 >= len) return -1;
        if (buf[i + 1] == '\n') return i;
        p = memchr(buf + i + 1, '\r', static_cast<size_t>(len - i - 1));
    }
    return -1;
}

// strict non-negative decimal with optional leading '-' (for "$-1"-style
// values the caller range-checks); returns false on empty/garbage
bool parse_int(const uint8_t* s, int64_t n, int64_t* out) {
    if (n <= 0) return false;
    bool neg = false;
    int64_t i = 0;
    if (s[0] == '-') {
        neg = true;
        i = 1;
        if (n == 1) return false;
    }
    int64_t v = 0;
    for (; i < n; i++) {
        if (s[i] < '0' || s[i] > '9') return false;
        if (v > (INT64_MAX - 9) / 10) return false;
        v = v * 10 + (s[i] - '0');
    }
    *out = neg ? -v : v;
    return true;
}

}  // namespace

extern "C" {

int32_t resp_scan(const uint8_t* buf, int64_t len, int64_t* consumed,
                  int64_t* offs, int64_t* lens, int32_t max_args,
                  int32_t* n_args) {
    *consumed = 0;
    *n_args = 0;
    if (len <= 0) return 0;

    if (buf[0] != '*') {
        // inline command: one text line, split on whitespace
        int64_t eol = find_crlf(buf, len, 0);
        if (eol < 0) return len > MAX_LINE ? -1 : 0;
        // separator set matches Python bytes.split(): all ASCII whitespace
        auto is_sep = [](uint8_t c) {
            return c == ' ' || c == '\t' || c == '\n' || c == '\r' ||
                   c == '\v' || c == '\f';
        };
        int32_t count = 0;
        int64_t i = 0;
        while (i < eol) {
            while (i < eol && is_sep(buf[i])) i++;
            if (i >= eol) break;
            int64_t start = i;
            while (i < eol && !is_sep(buf[i])) i++;
            if (count < max_args) {
                offs[count] = start;
                lens[count] = i - start;
            }
            count++;
        }
        if (count > max_args) {
            *n_args = count;
            return -2;
        }
        *n_args = count;
        *consumed = eol + 2;
        return 1;
    }

    // RESP array of bulk strings
    int64_t eol = find_crlf(buf, len, 0);
    if (eol < 0) return len > MAX_LINE ? -1 : 0;
    int64_t n = 0;
    if (!parse_int(buf + 1, eol - 1, &n)) return -1;
    if (n < 0 || n > MAX_ARRAY) return -1;
    if (n > max_args) {
        *n_args = static_cast<int32_t>(n);
        return -2;
    }
    int64_t pos = eol + 2;
    for (int64_t k = 0; k < n; k++) {
        int64_t heol = find_crlf(buf, len, pos);
        if (heol < 0) return len - pos > MAX_LINE ? -1 : 0;
        if (buf[pos] != '$') return -1;
        int64_t blen = 0;
        if (!parse_int(buf + pos + 1, heol - pos - 1, &blen)) return -1;
        if (blen < 0 || blen > MAX_BULK) return -1;
        int64_t body = heol + 2;
        if (body + blen + 2 > len) return 0;
        if (buf[body + blen] != '\r' || buf[body + blen + 1] != '\n') return -1;
        offs[k] = body;
        lens[k] = blen;
        pos = body + blen + 2;
    }
    *n_args = static_cast<int32_t>(n);
    *consumed = pos;
    return 1;
}

// Batch scanner: parse as many complete commands as fit in `buf`,
// amortising the FFI round-trip over a whole pipelined burst.
//
// Outputs: cmd_argc[c] = arg count of command c (an inline blank line
// yields argc -1, meaning "skip"); flat offs/lens hold every argument
// slice in order. Stops at max_cmds commands, max_args total slices, end
// of input, or an incomplete tail.
// Returns: number of parsed commands (>= 0), or -1 on protocol error
// (*consumed then covers the commands parsed BEFORE the error; the
// connection should be dropped after serving them).
int32_t resp_scan_many(const uint8_t* buf, int64_t len, int64_t* consumed,
                       int32_t* cmd_argc, int32_t max_cmds,
                       int64_t* offs, int64_t* lens, int32_t max_args,
                       int32_t* n_args) {
    *consumed = 0;
    *n_args = 0;
    int32_t n_cmds = 0;
    while (n_cmds < max_cmds) {
        int64_t sub_consumed = 0;
        int32_t sub_args = 0;
        int32_t rc =
            resp_scan(buf + *consumed, len - *consumed, &sub_consumed,
                      offs + *n_args, lens + *n_args, max_args - *n_args,
                      &sub_args);
        if (rc == 0) break;  // incomplete tail
        if (rc == -2) {      // caller grows arrays and rescans the tail
            if (n_cmds == 0) {
                *n_args = sub_args;  // required capacity
                return -2;
            }
            break;
        }
        if (rc == -1) return n_cmds ? n_cmds : -1;  // serve prefix first
        bool inline_blank = sub_args == 0 && buf[*consumed] != '*';
        for (int32_t i = 0; i < sub_args; i++) offs[*n_args + i] += *consumed;
        cmd_argc[n_cmds++] = inline_blank ? -1 : sub_args;
        *n_args += sub_args;
        *consumed += sub_consumed;
    }
    return n_cmds;
}

}  // extern "C"
