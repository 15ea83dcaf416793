// Native IQ stream runtime: lock-protected ring buffer + reader threads.
//
// TPU-native equivalent of the reference's runtime fabric (SDR++
// dsp::stream<T> double-buffered handoffs + one worker thread per block,
// SURVEY.md section 2.10): a single producer thread (file pacer or UDP
// receiver) feeds a ring of complex64 samples; the Python driver pulls
// fixed-size blocks for the batched device pipeline.  Handles backpressure
// accounting (overruns) and realtime pacing for file playback.
//
// Plain C ABI for ctypes; pthreads via std::thread.

#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

#include <arpa/inet.h>
#include <netinet/in.h>
#include <sys/socket.h>
#include <unistd.h>

namespace {

struct IqRing {
    std::vector<float> buf;       // interleaved re,im
    size_t capacity;              // in samples
    size_t head = 0;              // write index (samples)
    size_t tail = 0;              // read index (samples)
    std::mutex mtx;
    std::condition_variable cv;
    std::atomic<uint64_t> total_in{0};
    std::atomic<uint64_t> overruns{0};
    std::atomic<bool> running{true};
    std::atomic<bool> eof{false};
    std::thread worker;
    int sock_fd = -1;

    explicit IqRing(size_t cap) : buf(2 * cap), capacity(cap) {}

    size_t level() const { return head - tail; }  // monotonic counters

    void push(const float* iq, size_t n) {
        std::unique_lock<std::mutex> lk(mtx);
        for (size_t i = 0; i < n; i++) {
            if (level() >= capacity) {
                // drop-oldest on overflow, like a hardware stream
                tail++;
                overruns++;
            }
            size_t w = head % capacity;
            buf[2 * w] = iq[2 * i];
            buf[2 * w + 1] = iq[2 * i + 1];
            head++;
        }
        total_in += n;
        cv.notify_all();
    }

    size_t pop(float* out, size_t n, int timeout_ms) {
        std::unique_lock<std::mutex> lk(mtx);
        auto deadline = std::chrono::steady_clock::now()
                        + std::chrono::milliseconds(timeout_ms);
        while (level() < n && running && !eof) {
            if (cv.wait_until(lk, deadline) == std::cv_status::timeout)
                break;
        }
        size_t avail = level();
        size_t take = avail < n ? avail : n;
        for (size_t i = 0; i < take; i++) {
            size_t r = tail % capacity;
            out[2 * i] = buf[2 * r];
            out[2 * i + 1] = buf[2 * r + 1];
            tail++;
        }
        return take;
    }
};

void file_worker(IqRing* ring, std::string path, double rate_sps) {
    FILE* f = fopen(path.c_str(), "rb");
    if (!f) {
        ring->eof = true;
        ring->cv.notify_all();
        return;
    }
    const size_t chunk = 4096;
    std::vector<float> tmp(2 * chunk);
    auto t0 = std::chrono::steady_clock::now();
    uint64_t sent = 0;
    while (ring->running) {
        size_t got = fread(tmp.data(), 2 * sizeof(float), chunk, f);
        if (got == 0)
            break;
        ring->push(tmp.data(), got);
        sent += got;
        if (rate_sps > 0) {
            // realtime pacing: sleep until wall clock catches up
            auto target = t0 + std::chrono::microseconds(
                (uint64_t)(sent * 1e6 / rate_sps));
            std::this_thread::sleep_until(target);
        }
    }
    fclose(f);
    ring->eof = true;
    ring->cv.notify_all();
}

void udp_worker(IqRing* ring, int fd) {
    std::vector<float> tmp(2 * 16384);
    while (ring->running) {
        ssize_t n = recv(fd, tmp.data(), tmp.size() * sizeof(float), 0);
        if (n <= 0) {
            if (!ring->running)
                break;
            continue;
        }
        ring->push(tmp.data(), (size_t)n / (2 * sizeof(float)));
    }
}

}  // namespace

extern "C" {

void* iqstream_create(uint64_t capacity_samples) {
    return new IqRing(capacity_samples);
}

int iqstream_feed_file(void* h, const char* path, double rate_sps) {
    IqRing* r = (IqRing*)h;
    r->worker = std::thread(file_worker, r, std::string(path), rate_sps);
    return 0;
}

int iqstream_open_udp(void* h, int port) {
    IqRing* r = (IqRing*)h;
    int fd = socket(AF_INET, SOCK_DGRAM, 0);
    if (fd < 0)
        return -1;
    struct timeval tv {0, 200000};  // 200 ms poll so stop() is responsive
    setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
    sockaddr_in addr{};
    addr.sin_family = AF_INET;
    addr.sin_addr.s_addr = htonl(INADDR_ANY);
    addr.sin_port = htons((uint16_t)port);
    if (bind(fd, (sockaddr*)&addr, sizeof(addr)) < 0) {
        close(fd);
        return -2;
    }
    r->sock_fd = fd;
    r->worker = std::thread(udp_worker, r, fd);
    return 0;
}

// Blocking read of up to n samples into out (interleaved float32 pairs).
// Returns samples read (< n on timeout/EOF; 0 when drained after EOF).
uint64_t iqstream_read(void* h, float* out, uint64_t n, int timeout_ms) {
    return ((IqRing*)h)->pop(out, n, timeout_ms);
}

uint64_t iqstream_total(void* h) { return ((IqRing*)h)->total_in.load(); }
uint64_t iqstream_overruns(void* h) { return ((IqRing*)h)->overruns.load(); }
uint64_t iqstream_level(void* h) {
    IqRing* r = (IqRing*)h;
    std::unique_lock<std::mutex> lk(r->mtx);
    return r->level();
}
int iqstream_eof(void* h) { return ((IqRing*)h)->eof.load() ? 1 : 0; }

void iqstream_stop(void* h) {
    IqRing* r = (IqRing*)h;
    r->running = false;
    r->cv.notify_all();
    if (r->sock_fd >= 0)
        shutdown(r->sock_fd, SHUT_RDWR);
    if (r->worker.joinable())
        r->worker.join();
    if (r->sock_fd >= 0) {
        close(r->sock_fd);
        r->sock_fd = -1;
    }
}

void iqstream_destroy(void* h) {
    iqstream_stop(h);
    delete (IqRing*)h;
}

}  // extern "C"
