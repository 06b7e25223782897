"""step.host_syncs: the synchronising operations of one call of the
port's step (torch.cuda.set_sync_debug_mode), the harness's upload and
output copy not counted; each kind is listed on standard error."""
import collections
import sys


def read(run):
    for msg, n in collections.Counter(run.syncs).most_common():
        print(f"host sync x{n}: {msg}", file=sys.stderr)
    return float(len(run.syncs))
