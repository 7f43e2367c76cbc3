// vokselis native IO runtime.
//
// C++ rebuild of the reference's performance-sensitive host components
// (which are Rust there):
//   - raw volume loading            (src/context/volume_texture.rs:33-59)
//   - PNG screenshot encoding       (src/utils/recorder.rs:189-217, `png` crate)
//   - async frame sink: worker thread + queue piping raw RGBA frames into an
//     ffmpeg child process / PNG files (src/utils/recorder.rs:25-187)
//   - row-padding strip             (src/utils/recorder.rs:155-164)
//
// Exposed as a C ABI for ctypes (no pybind11 in this image). All functions
// return 0 on success, negative on failure.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <chrono>
#include <condition_variable>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/stat.h>
#include <sys/wait.h>
#include <unistd.h>
#include <zlib.h>

extern "C" {

// ---------------------------------------------------------------- raw IO --
int vx_load_raw(const char* path, uint8_t* out, int64_t size) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  size_t got = fread(out, 1, (size_t)size, f);
  fclose(f);
  return got == (size_t)size ? 0 : -2;
}

// ------------------------------------------------------------------- PNG --
// Minimal PNG writer: 8-bit grey/RGB/RGBA, filter 0, one zlib IDAT.
static void put_be32(std::vector<uint8_t>& v, uint32_t x) {
  v.push_back(x >> 24); v.push_back(x >> 16); v.push_back(x >> 8); v.push_back(x);
}

static void chunk(std::vector<uint8_t>& out, const char tag[4],
                  const uint8_t* data, size_t len) {
  put_be32(out, (uint32_t)len);
  size_t start = out.size();
  out.insert(out.end(), tag, tag + 4);
  out.insert(out.end(), data, data + len);
  uint32_t crc = crc32(0, out.data() + start, (uInt)(len + 4));
  put_be32(out, crc);
}

static int encode_png(const uint8_t* img, int h, int w, int c, int level,
                      std::vector<uint8_t>& out) {
  if (c != 1 && c != 3 && c != 4) return -1;
  static const uint8_t color_type[] = {0, 0, 0, 2, 6};
  // raw scanlines with filter byte 0
  std::vector<uint8_t> raw((size_t)h * (1 + (size_t)w * c));
  for (int y = 0; y < h; y++) {
    uint8_t* row = raw.data() + (size_t)y * (1 + (size_t)w * c);
    row[0] = 0;
    memcpy(row + 1, img + (size_t)y * w * c, (size_t)w * c);
  }
  uLongf bound = compressBound((uLong)raw.size());
  std::vector<uint8_t> comp(bound);
  if (compress2(comp.data(), &bound, raw.data(), (uLong)raw.size(), level) != Z_OK)
    return -2;
  comp.resize(bound);

  out.clear();
  static const uint8_t sig[] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  out.insert(out.end(), sig, sig + 8);
  uint8_t ihdr[13];
  ihdr[0] = w >> 24; ihdr[1] = w >> 16; ihdr[2] = w >> 8; ihdr[3] = w;
  ihdr[4] = h >> 24; ihdr[5] = h >> 16; ihdr[6] = h >> 8; ihdr[7] = h;
  ihdr[8] = 8; ihdr[9] = color_type[c]; ihdr[10] = 0; ihdr[11] = 0; ihdr[12] = 0;
  chunk(out, "IHDR", ihdr, 13);
  chunk(out, "IDAT", comp.data(), comp.size());
  chunk(out, "IEND", nullptr, 0);
  return 0;
}

int vx_write_png(const char* path, const uint8_t* img, int h, int w, int c,
                 int level) {
  std::vector<uint8_t> out;
  int rc = encode_png(img, h, w, c, level, out);
  if (rc) return rc;
  FILE* f = fopen(path, "wb");
  if (!f) return -3;
  size_t wrote = fwrite(out.data(), 1, out.size(), f);
  fclose(f);
  return wrote == out.size() ? 0 : -4;
}

// ------------------------------------------------- row padding utilities --
// Strip wgpu-style 256-byte-aligned row padding (recorder.rs:155-164).
int vx_strip_rows(const uint8_t* src, uint8_t* dst, int h,
                  int padded_bpr, int unpadded_bpr) {
  for (int y = 0; y < h; y++)
    memcpy(dst + (size_t)y * unpadded_bpr, src + (size_t)y * padded_bpr,
           (size_t)unpadded_bpr);
  return 0;
}

// -------------------------------------------------------- frame recorder --
// Worker thread consuming an unbounded frame queue (recorder.rs:48-56),
// writing PNG screenshots and piping raw RGBA video frames into ffmpeg.
struct Frame {
  std::vector<uint8_t> data;
  int h, w, c;
  int kind;  // 0 = video frame, 1 = screenshot
  std::string path;
};

struct Recorder {
  std::deque<Frame> queue;
  std::mutex mu;
  std::condition_variable cv;
  std::thread worker;
  FILE* ffmpeg = nullptr;   // guarded by mu; stable while `busy` is true
  pid_t ffmpeg_pid = -1;
  bool stop = false;
  bool busy = false;  // worker holds a popped frame it hasn't written yet
  int dropped = 0;

  void run() {
    for (;;) {
      Frame fr;
      FILE* sink = nullptr;
      {
        std::unique_lock<std::mutex> lk(mu);
        cv.wait(lk, [&] { return stop || !queue.empty(); });
        if (queue.empty()) {
          if (stop) return;
          continue;
        }
        fr = std::move(queue.front());
        queue.pop_front();
        busy = true;  // finish_video must not pclose until this write lands
        sink = ffmpeg;
      }
      if (fr.kind == 1) {
        vx_write_png(fr.path.c_str(), fr.data.data(), fr.h, fr.w, fr.c, 1);
      } else if (sink) {
        fwrite(fr.data.data(), 1, fr.data.size(), sink);
      }
      {
        std::lock_guard<std::mutex> lk(mu);
        busy = false;
      }
      cv.notify_all();
    }
  }
};

void* vx_recorder_new() {
  auto* r = new Recorder();
  r->worker = std::thread([r] { r->run(); });
  return r;
}

int vx_recorder_start_video(void* rec, const char* out_path, int w, int h,
                            int fps) {
  auto* r = (Recorder*)rec;
  std::lock_guard<std::mutex> lk(r->mu);
  if (r->ffmpeg) return -1;
  // recorder.rs:79-127: raw RGBA pipe -> x264 crf 15 yuv420p.
  // argv exec (no shell): out_path with quotes/metacharacters is safe, and
  // arbitrary-length paths work (mirrors media/recorder.py's list-args Popen)
  std::string fps_s = std::to_string(fps);
  std::string size_s = std::to_string(w) + "x" + std::to_string(h);
  const char* argv[] = {
      "ffmpeg", "-loglevel", "error", "-framerate", fps_s.c_str(),
      "-pix_fmt", "rgba", "-f", "rawvideo", "-s", size_s.c_str(),
      "-i", "pipe:", "-c:v", "libx264", "-crf", "15", "-preset", "slow",
      "-tune", "animation", "-pix_fmt", "yuv420p", "-an", "-y",
      out_path, nullptr};
  int fds[2];
  if (pipe(fds) != 0) return -2;
  pid_t pid = fork();
  if (pid < 0) {
    close(fds[0]);
    close(fds[1]);
    return -2;
  }
  if (pid == 0) {  // child: stdin <- pipe read end, exec ffmpeg
    dup2(fds[0], 0);
    close(fds[0]);
    close(fds[1]);
    execvp("ffmpeg", const_cast<char* const*>(argv));
    _exit(127);
  }
  close(fds[0]);
  FILE* sink = fdopen(fds[1], "w");
  if (!sink) {
    close(fds[1]);
    waitpid(pid, nullptr, 0);
    return -2;
  }
  r->ffmpeg = sink;
  r->ffmpeg_pid = pid;
  return 0;
}

int vx_recorder_push_frame(void* rec, const uint8_t* data, int h, int w, int c) {
  auto* r = (Recorder*)rec;
  Frame fr;
  fr.data.assign(data, data + (size_t)h * w * c);
  fr.h = h; fr.w = w; fr.c = c; fr.kind = 0;
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->queue.push_back(std::move(fr));
  }
  r->cv.notify_one();
  return 0;
}

int vx_recorder_screenshot(void* rec, const char* path, const uint8_t* data,
                           int h, int w, int c) {
  auto* r = (Recorder*)rec;
  Frame fr;
  fr.data.assign(data, data + (size_t)h * w * c);
  fr.h = h; fr.w = w; fr.c = c; fr.kind = 1; fr.path = path;
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->queue.push_back(std::move(fr));
  }
  r->cv.notify_one();
  return 0;
}

int vx_recorder_finish_video(void* rec) {
  auto* r = (Recorder*)rec;
  FILE* sink = nullptr;
  pid_t pid = -1;
  {
    // drained = queue empty AND no popped-but-unwritten frame in flight
    std::unique_lock<std::mutex> lk(r->mu);
    r->cv.wait(lk, [&] { return r->queue.empty() && !r->busy; });
    sink = r->ffmpeg;
    pid = r->ffmpeg_pid;
    r->ffmpeg = nullptr;
    r->ffmpeg_pid = -1;
  }
  if (sink) {
    fclose(sink);  // EOF on ffmpeg's stdin -> it finalises the file
    if (pid > 0) waitpid(pid, nullptr, 0);
  }
  return 0;
}

int vx_recorder_free(void* rec) {
  auto* r = (Recorder*)rec;
  vx_recorder_finish_video(rec);
  {
    std::lock_guard<std::mutex> lk(r->mu);
    r->stop = true;
  }
  r->cv.notify_one();
  r->worker.join();
  delete r;
  return 0;
}

}  // extern "C"
