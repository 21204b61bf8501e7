// Native dynamic-batching core.
//
// A copy of scalable_agent_tpu/native/batcher.cc for the PyTorch port: the
// same code, built from this copy (native/build.py).  It re-designs the
// reference's TF custom-op batcher (reference: batcher.cc:91-204 — mutex +
// condvar + request deque + computation-id map; :241-258 batch formation
// with min/timeout; :316-327 id-correlated scatter; :393-431
// close/cancellation cascade).  Key differences by design:
//
//  - No TF runtime: requests are fixed-size byte blobs (the Python layer
//    packs a sample tree into one contiguous buffer), so the core is a
//    dependency-free C++17 library driven through a C ABI (ctypes).
//  - The *compute* stays in Python (one PyTorch inference step on the
//    card).  C++ owns what the GIL makes slow: caller blocking/wakeup,
//    batch formation under contention, and gather/scatter memcpy.  Caller
//    threads block inside this library with the GIL released.
//  - Multiple in-flight batches complete out of order, correlated by
//    batch id, exactly as the reference allows.
//
// Build: g++ -std=c++17 -O2 -shared -fPIC -pthread batcher.cc -o libbatcher.so

#include <chrono>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <deque>
#include <mutex>
#include <unordered_map>
#include <vector>

namespace {

enum Status : int {
  kOk = 0,
  kClosed = 1,
  kTimeout = 2,
  kInvalid = 3,
};

struct Request {
  const uint8_t* sample;     // caller-owned until done
  uint8_t* result;           // caller-owned output slot
  bool done = false;
  int status = kOk;
  std::condition_variable cv;
};

class Batcher {
 public:
  Batcher(int64_t sample_bytes, int64_t result_bytes, int min_batch,
          int max_batch, double timeout_ms)
      : sample_bytes_(sample_bytes),
        result_bytes_(result_bytes),
        min_batch_(min_batch),
        max_batch_(max_batch),
        timeout_ms_(timeout_ms) {}

  // Caller side: block until the result slot is filled (or closed).
  int Compute(const uint8_t* sample, uint8_t* result) {
    Request request;
    request.sample = sample;
    request.result = result;
    {
      std::unique_lock<std::mutex> lock(mu_);
      if (closed_) return kClosed;
      pending_.push_back(&request);
      nonempty_.notify_all();
      request.cv.wait(lock, [&] { return request.done; });
    }
    return request.status;
  }

  // Consumer side: block until a batch forms; gather samples into
  // batch_buf ([max_batch, sample_bytes], first *n rows valid); returns a
  // batch id for SetResults.  (reference: batcher.cc:228-279 GetInputs)
  int GetBatch(uint8_t* batch_buf, int* n, int64_t* batch_id) {
    std::vector<Request*> batch;
    {
      std::unique_lock<std::mutex> lock(mu_);
      bool have_deadline = false;
      std::chrono::steady_clock::time_point deadline;
      while (true) {
        if (closed_) return kClosed;
        if (static_cast<int>(pending_.size()) >= min_batch_) break;
        if (pending_.empty()) {
          have_deadline = false;
          nonempty_.wait(lock);
          continue;
        }
        if (timeout_ms_ < 0) {  // no timeout: wait for min_batch
          nonempty_.wait(lock);
          continue;
        }
        if (!have_deadline) {
          deadline = std::chrono::steady_clock::now() +
                     std::chrono::duration_cast<
                         std::chrono::steady_clock::duration>(
                         std::chrono::duration<double, std::milli>(
                             timeout_ms_));
          have_deadline = true;
        }
        if (nonempty_.wait_until(lock, deadline) ==
            std::cv_status::timeout) {
          if (!pending_.empty()) break;  // flush partial batch
          have_deadline = false;
        }
      }
      int take = static_cast<int>(pending_.size());
      if (take > max_batch_) take = max_batch_;
      batch.reserve(take);
      for (int i = 0; i < take; ++i) {
        batch.push_back(pending_.front());
        pending_.pop_front();
      }
      *batch_id = next_batch_id_++;
      // Gather while still holding the lock: Close() may otherwise wake a
      // caller whose stack-owned Request/sample dies mid-memcpy.
      *n = static_cast<int>(batch.size());
      for (int i = 0; i < *n; ++i) {
        std::memcpy(batch_buf + static_cast<int64_t>(i) * sample_bytes_,
                    batch[i]->sample, sample_bytes_);
      }
      in_flight_.emplace(*batch_id, std::move(batch));
    }
    return kOk;
  }

  // Consumer side: scatter result rows back and wake the callers.
  // (reference: batcher.cc:339-391 SetOutputs)
  int SetResults(int64_t batch_id, const uint8_t* results, int status) {
    std::vector<Request*> batch;
    {
      std::unique_lock<std::mutex> lock(mu_);
      auto it = in_flight_.find(batch_id);
      if (it == in_flight_.end()) return kInvalid;
      batch = std::move(it->second);
      in_flight_.erase(it);
    }
    for (size_t i = 0; i < batch.size(); ++i) {
      if (status == kOk) {
        std::memcpy(batch[i]->result,
                    results + i * static_cast<size_t>(result_bytes_),
                    result_bytes_);
      }
    }
    {
      std::unique_lock<std::mutex> lock(mu_);
      for (Request* request : batch) {
        request->status = status;
        request->done = true;
        request->cv.notify_one();
      }
    }
    return kOk;
  }

  // Cancel everything: pending and in-flight callers get kClosed.
  // (reference: batcher.cc:393-431)
  void Close() {
    std::unique_lock<std::mutex> lock(mu_);
    closed_ = true;
    for (Request* request : pending_) {
      request->status = kClosed;
      request->done = true;
      request->cv.notify_one();
    }
    pending_.clear();
    for (auto& entry : in_flight_) {
      for (Request* request : entry.second) {
        request->status = kClosed;
        request->done = true;
        request->cv.notify_one();
      }
    }
    in_flight_.clear();
    nonempty_.notify_all();
  }

  int64_t sample_bytes() const { return sample_bytes_; }
  int64_t result_bytes() const { return result_bytes_; }

 private:
  const int64_t sample_bytes_;
  const int64_t result_bytes_;
  const int min_batch_;
  const int max_batch_;
  const double timeout_ms_;  // < 0: wait forever for min_batch

  std::mutex mu_;
  std::condition_variable nonempty_;
  std::deque<Request*> pending_;
  std::unordered_map<int64_t, std::vector<Request*>> in_flight_;
  int64_t next_batch_id_ = 0;
  bool closed_ = false;
};

}  // namespace

extern "C" {

void* batcher_create(int64_t sample_bytes, int64_t result_bytes,
                     int min_batch, int max_batch, double timeout_ms) {
  return new Batcher(sample_bytes, result_bytes, min_batch, max_batch,
                     timeout_ms);
}

int batcher_compute(void* handle, const uint8_t* sample, uint8_t* result) {
  return static_cast<Batcher*>(handle)->Compute(sample, result);
}

int batcher_get_batch(void* handle, uint8_t* batch_buf, int* n,
                      int64_t* batch_id) {
  return static_cast<Batcher*>(handle)->GetBatch(batch_buf, n, batch_id);
}

int batcher_set_results(void* handle, int64_t batch_id,
                        const uint8_t* results, int status) {
  return static_cast<Batcher*>(handle)->SetResults(batch_id, results,
                                                   status);
}

void batcher_close(void* handle) {
  static_cast<Batcher*>(handle)->Close();
}

void batcher_destroy(void* handle) {
  static_cast<Batcher*>(handle)->Close();
  delete static_cast<Batcher*>(handle);
}

}  // extern "C"
