// Fast columnar OHLCV CSV loader.
//
// The native side of the data pipeline: parses gym-fx-style bar CSVs
// (DATE_TIME,OPEN,HIGH,LOW,CLOSE,VOLUME — reference
// examples/data/eurusd_sample.csv schema) straight into preallocated
// column arrays, with a fixed-format "YYYY-MM-DD HH:MM:SS" timestamp
// fast path.  Exposed through ctypes (gymfx_tpu_torch/data/native_loader.py);
// any row the strict parser cannot handle makes the loader report
// failure and the Python side takes its numpy path, so exotic inputs
// load as they always did.
//
// Build: gymfx_tpu_torch/data/native_loader.py, at first use
// (g++ -O3 -shared -fPIC -std=c++17 into build/native/).

#include <cctype>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <ctime>
#include <vector>

namespace {

struct Parsed {
    std::vector<int64_t> epoch_s;
    std::vector<double> open, high, low, close, volume;
};

// days since epoch for a civil date (Howard Hinnant's algorithm)
int64_t days_from_civil(int y, int m, int d) {
    y -= m <= 2;
    const int64_t era = (y >= 0 ? y : y - 399) / 400;
    const unsigned yoe = static_cast<unsigned>(y - era * 400);
    const unsigned doy = (153u * (m + (m > 2 ? -3 : 9)) + 2) / 5 + d - 1;
    const unsigned doe = yoe * 365 + yoe / 4 - yoe / 100 + doy;
    return era * 146097 + static_cast<int64_t>(doe) - 719468;
}

bool parse_timestamp(const char* s, size_t len, int64_t* out) {
    // strict "YYYY-MM-DD HH:MM[:SS]" (or with 'T'); the WHOLE token must
    // match — trailing offsets/fractions/garbage refuse (numpy path)
    if (len != 16 && len != 19) return false;
    auto digit = [](char c) { return c >= '0' && c <= '9'; };
    for (int i : {0, 1, 2, 3, 5, 6, 8, 9, 11, 12, 14, 15})
        if (!digit(s[i])) return false;
    if (s[4] != '-' || s[7] != '-' || (s[10] != ' ' && s[10] != 'T') ||
        s[13] != ':')
        return false;
    int year = (s[0] - '0') * 1000 + (s[1] - '0') * 100 + (s[2] - '0') * 10 + (s[3] - '0');
    int mon = (s[5] - '0') * 10 + (s[6] - '0');
    int day = (s[8] - '0') * 10 + (s[9] - '0');
    int hh = (s[11] - '0') * 10 + (s[12] - '0');
    int mm = (s[14] - '0') * 10 + (s[15] - '0');
    int ss = 0;
    if (len == 19) {
        if (s[16] != ':' || !digit(s[17]) || !digit(s[18])) return false;
        ss = (s[17] - '0') * 10 + (s[18] - '0');
    }
    if (mon < 1 || mon > 12 || day < 1 || day > 31 || hh > 23 || mm > 59 || ss > 60)
        return false;
    *out = days_from_civil(year, mon, day) * 86400 + hh * 3600 + mm * 60 + ss;
    return true;
}

}  // namespace

extern "C" {

// Parse the file; returns a handle (>0) on success, 0 on failure.
// Column order matched by name against the header (case-insensitive).
void* gymfx_csv_parse(const char* path, int64_t* n_rows_out) {
    FILE* f = std::fopen(path, "rb");
    if (!f) return nullptr;
    std::fseek(f, 0, SEEK_END);
    long size = std::ftell(f);
    std::fseek(f, 0, SEEK_SET);
    std::vector<char> buf(static_cast<size_t>(size) + 1);
    if (std::fread(buf.data(), 1, size, f) != static_cast<size_t>(size)) {
        std::fclose(f);
        return nullptr;
    }
    std::fclose(f);
    buf[size] = '\0';

    char* p = buf.data();
    char* end = buf.data() + size;

    // ---- header ----------------------------------------------------
    char* line_end = static_cast<char*>(memchr(p, '\n', end - p));
    if (!line_end) return nullptr;
    int col_map[6] = {-1, -1, -1, -1, -1, -1};  // dt,o,h,l,c,v -> column idx
    {
        int col = 0;
        char* q = p;
        while (q < line_end) {
            char* comma = static_cast<char*>(memchr(q, ',', line_end - q));
            char* tok_end = comma ? comma : line_end;
            size_t len = tok_end - q;
            while (len && (q[len - 1] == '\r' || q[len - 1] == ' ')) --len;
            auto is = [&](const char* name) {
                size_t nl = std::strlen(name);
                if (len != nl) return false;
                for (size_t i = 0; i < nl; ++i)
                    if (std::toupper(q[i]) != name[i]) return false;
                return true;
            };
            if (is("DATE_TIME")) col_map[0] = col;
            else if (is("OPEN")) col_map[1] = col;
            else if (is("HIGH")) col_map[2] = col;
            else if (is("LOW")) col_map[3] = col;
            else if (is("CLOSE")) col_map[4] = col;
            else if (is("VOLUME")) col_map[5] = col;
            if (!comma) break;
            q = comma + 1;
            ++col;
        }
    }
    if (col_map[0] < 0 || col_map[4] < 0) return nullptr;  // need time+close
    p = line_end + 1;

    auto* out = new Parsed();
    // ---- rows ------------------------------------------------------
    while (p < end && *p) {
        line_end = static_cast<char*>(memchr(p, '\n', end - p));
        if (!line_end) line_end = end;
        if (line_end - p > 1) {
            int col = 0;
            char* q = p;
            int64_t ts = 0;
            double vals[6] = {0, 0, 0, 0, 0, 0};
            bool seen[6] = {false, false, false, false, false, false};
            bool ok = true;
            while (q <= line_end && ok) {
                char* comma = static_cast<char*>(memchr(q, ',', line_end - q));
                char* tok_end = comma ? comma : line_end;
                size_t len = tok_end - q;
                while (len && (q[len - 1] == '\r' || q[len - 1] == ' ')) --len;
                for (int k = 0; k < 6; ++k) {
                    if (col != col_map[k]) continue;
                    if (k == 0) {
                        ok = parse_timestamp(q, len, &ts);
                    } else {
                        char* conv_end = nullptr;
                        vals[k] = std::strtod(q, &conv_end);
                        // whole trimmed token must be consumed: trailing
                        // garbage means silent truncation, so refuse
                        ok = conv_end == q + len && len > 0;
                    }
                    seen[k] = ok;
                }
                if (!comma || comma >= line_end) break;
                q = comma + 1;
                ++col;
            }
            if (!ok || !seen[0] || !seen[4]) {
                delete out;
                return nullptr;  // strict: any bad row -> numpy path
            }
            double close = vals[4];
            out->epoch_s.push_back(ts);
            out->open.push_back(seen[1] ? vals[1] : close);
            out->high.push_back(seen[2] ? vals[2] : close);
            out->low.push_back(seen[3] ? vals[3] : close);
            out->close.push_back(close);
            out->volume.push_back(seen[5] ? vals[5] : 0.0);
        }
        p = line_end + 1;
    }
    *n_rows_out = static_cast<int64_t>(out->close.size());
    return out;
}

void gymfx_csv_fill(void* handle, int64_t* epoch_s, double* open, double* high,
                    double* low, double* close, double* volume) {
    auto* parsed = static_cast<Parsed*>(handle);
    const size_t n = parsed->close.size();
    std::memcpy(epoch_s, parsed->epoch_s.data(), n * sizeof(int64_t));
    std::memcpy(open, parsed->open.data(), n * sizeof(double));
    std::memcpy(high, parsed->high.data(), n * sizeof(double));
    std::memcpy(low, parsed->low.data(), n * sizeof(double));
    std::memcpy(close, parsed->close.data(), n * sizeof(double));
    std::memcpy(volume, parsed->volume.data(), n * sizeof(double));
}

void gymfx_csv_free(void* handle) {
    delete static_cast<Parsed*>(handle);
}

}  // extern "C"
