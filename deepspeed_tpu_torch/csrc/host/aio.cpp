// Asynchronous file I/O for ZeRO-Infinity's NVMe swapping: a pool of
// worker threads servicing pread / pwrite requests against files, with
// completion ids to wait on and a drain that counts failures nobody waited
// for. Plain pread / pwrite on the pool (portable: io_uring / libaio depend
// on the kernel's configuration).
//
// Compiled with the host compiler at first use by
// deepspeed_tpu_torch/ops/_build.py (load_host) and called through ctypes by
// deepspeed_tpu_torch/ops/aio/handle.py. The pool is the JAX package's
// csrc/aio.cpp.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <fcntl.h>
#include <mutex>
#include <string>
#include <thread>
#include <unistd.h>
#include <unordered_set>
#include <vector>

namespace {

struct Request {
  int id;
  bool write;
  std::string path;
  void* buf;
  int64_t nbytes;
  int64_t offset;
  bool fsync;
};

struct Pool {
  std::vector<std::thread> workers;
  std::deque<Request> queue;
  std::mutex mu;
  std::condition_variable cv;
  std::condition_variable done_cv;
  std::atomic<bool> stop{false};
  int next_id = 1;
  // completed request ids with status (0 ok, negative errno); `pending` tracks
  // submitted-but-unfinished ids so wait() can distinguish "still running"
  // from "already completed and its record consumed/discarded"
  std::mutex done_mu;
  std::vector<std::pair<int, int>> done;
  std::unordered_set<int> pending;
  std::atomic<int> inflight{0};

  void push_done(int id, int status) {
    std::lock_guard<std::mutex> g(done_mu);
    pending.erase(id);
    done.emplace_back(id, status);
  }

  // Returns the status (<= 0) if finished, 1 if still pending, -EINVAL if
  // unknown (already waited on, discarded by drain, or never submitted) —
  // callers must hold each id's result exactly once or use drain().
  int take_status(int id) {
    std::lock_guard<std::mutex> g(done_mu);
    for (auto it = done.begin(); it != done.end(); ++it) {
      if (it->first == id) {
        int s = it->second;
        done.erase(it);
        return s;
      }
    }
    return pending.count(id) ? 1 : -EINVAL;
  }
};

int do_io(const Request& r) {
  int flags = r.write ? (O_WRONLY | O_CREAT) : O_RDONLY;
  int fd = ::open(r.path.c_str(), flags, 0644);
  if (fd < 0) return -errno;
  char* p = (char*)r.buf;
  int64_t left = r.nbytes;
  int64_t off = r.offset;
  while (left > 0) {
    ssize_t n = r.write ? ::pwrite(fd, p, left, off) : ::pread(fd, p, left, off);
    if (n < 0) {
      int e = errno;
      ::close(fd);
      return -e;
    }
    if (n == 0) break;  // EOF on read
    p += n;
    left -= n;
    off += n;
  }
  int rc = 0;
  if (left != 0) rc = -EIO;
  if (r.write && r.fsync && rc == 0 && ::fsync(fd) != 0) rc = -errno;
  ::close(fd);
  return rc;
}

void worker(Pool* pool) {
  for (;;) {
    Request r;
    {
      std::unique_lock<std::mutex> lk(pool->mu);
      pool->cv.wait(lk, [&] { return pool->stop || !pool->queue.empty(); });
      if (pool->stop && pool->queue.empty()) return;
      r = pool->queue.front();
      pool->queue.pop_front();
    }
    int rc = do_io(r);
    pool->push_done(r.id, rc);
    pool->inflight.fetch_sub(1);
    pool->done_cv.notify_all();
  }
}

}  // namespace

extern "C" {

void* ds_aio_create(int num_threads) {
  auto* pool = new Pool();
  if (num_threads < 1) num_threads = 1;
  for (int i = 0; i < num_threads; ++i) pool->workers.emplace_back(worker, pool);
  return pool;
}

void ds_aio_destroy(void* h) {
  auto* pool = (Pool*)h;
  {
    std::lock_guard<std::mutex> g(pool->mu);
    pool->stop = true;
  }
  pool->cv.notify_all();
  for (auto& t : pool->workers) t.join();
  delete pool;
}

static int submit(Pool* pool, bool write, const char* path, void* buf,
                  int64_t nbytes, int64_t offset, int fsync) {
  int id;
  {
    std::lock_guard<std::mutex> g(pool->mu);
    id = pool->next_id++;
  }
  // bookkeeping BEFORE the request becomes runnable, or a fast worker could
  // complete it and erase a pending entry that was never inserted
  {
    std::lock_guard<std::mutex> g(pool->done_mu);
    pool->pending.insert(id);
  }
  pool->inflight.fetch_add(1);
  {
    std::lock_guard<std::mutex> g(pool->mu);
    pool->queue.push_back(
        Request{id, write, path, buf, nbytes, offset, fsync != 0});
  }
  pool->cv.notify_one();
  return id;
}

// Submit async ops; returns a request id. The buffer must stay alive until wait.
int ds_aio_pread(void* h, const char* path, void* buf, int64_t nbytes,
                 int64_t offset) {
  return submit((Pool*)h, false, path, buf, nbytes, offset, 0);
}

int ds_aio_pwrite(void* h, const char* path, const void* buf, int64_t nbytes,
                  int64_t offset, int fsync) {
  return submit((Pool*)h, true, path, (void*)buf, nbytes, offset, fsync);
}

// Block until request `id` completes; returns 0 on success, -errno on failure.
int ds_aio_wait(void* h, int id) {
  auto* pool = (Pool*)h;
  for (;;) {
    int s = pool->take_status(id);
    if (s <= 0) return s;
    std::unique_lock<std::mutex> lk(pool->done_mu);
    pool->done_cv.wait_for(lk, std::chrono::milliseconds(50));
  }
}

// Block until every submitted request completes. Discards completion records
// nobody waited on (fire-and-forget writes) so the done list cannot grow
// without bound — but COUNTS discarded failures: returns 0 if everything
// succeeded, -N if N discarded requests had failed since the last drain.
int ds_aio_drain(void* h) {
  auto* pool = (Pool*)h;
  while (pool->inflight.load() > 0) {
    std::unique_lock<std::mutex> lk(pool->done_mu);
    pool->done_cv.wait_for(lk, std::chrono::milliseconds(50));
  }
  int failures = 0;
  {
    std::lock_guard<std::mutex> g(pool->done_mu);
    for (auto& rec : pool->done)
      if (rec.second < 0) ++failures;
    pool->done.clear();
  }
  return -failures;
}

int ds_aio_version() { return 1; }
}
