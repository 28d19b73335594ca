/* Native batch gather for the mmap embedding store.
 *
 * The reference's embedding-store hot path went through np.memmap + SQLite
 * per row (reference: dashboard/mmap_embedding_loader.py). Here the Python
 * layer keeps the flat offset index and hands this routine a list of row
 * offsets; it memcpy's all rows from the mapped blob into one contiguous
 * output buffer, parallelized across POSIX threads. This is the host-side
 * analogue of the reference's "native" storage layer (the card never touches
 * it: batches are copied to it afterwards). The port's copy of
 * deepearth_tpu/data/csrc/fast_gather.c, built by
 * deepearth_tpu_torch/data/native.py under build/native/.
 *
 * Build: cc -O3 -shared -fPIC -pthread fast_gather.c -o libfastgather.so
 */

#include <pthread.h>
#include <stdint.h>
#include <string.h>

typedef struct {
    const char *base;        /* mmap'd blob base address            */
    const int64_t *offsets;  /* per-row byte offsets into the blob  */
    char *out;               /* contiguous output buffer            */
    int64_t row_bytes;       /* bytes per row                       */
    int start;               /* first row index for this worker     */
    int end;                 /* one past the last row index         */
} gather_task;

static void *gather_worker(void *arg) {
    gather_task *t = (gather_task *)arg;
    for (int i = t->start; i < t->end; ++i) {
        memcpy(t->out + (int64_t)i * t->row_bytes,
               t->base + t->offsets[i],
               (size_t)t->row_bytes);
    }
    return 0;
}

/* Gather n rows of row_bytes each from base at the given byte offsets into
 * out. n_threads <= 1 runs inline. Returns 0 on success. */
int gather_rows(const char *base, const int64_t *offsets, int n,
                int64_t row_bytes, char *out, int n_threads) {
    if (n <= 0) return 0;
    if (n_threads <= 1 || n < n_threads * 4) {
        gather_task t = {base, offsets, out, row_bytes, 0, n};
        gather_worker(&t);
        return 0;
    }
    if (n_threads > 16) n_threads = 16;
    pthread_t threads[16];
    gather_task tasks[16];
    int per = (n + n_threads - 1) / n_threads;
    int used = 0;
    for (int w = 0; w < n_threads; ++w) {
        int s = w * per;
        int e = s + per < n ? s + per : n;
        if (s >= e) break;
        tasks[w].base = base;
        tasks[w].offsets = offsets;
        tasks[w].out = out;
        tasks[w].row_bytes = row_bytes;
        tasks[w].start = s;
        tasks[w].end = e;
        if (pthread_create(&threads[w], 0, gather_worker, &tasks[w]) != 0) {
            /* thread spawn failed: run remaining rows inline */
            gather_task rest = {base, offsets, out, row_bytes, s, n};
            gather_worker(&rest);
            n_threads = w;
            break;
        }
        used = w + 1;
    }
    for (int w = 0; w < used; ++w) pthread_join(threads[w], 0);
    return 0;
}
