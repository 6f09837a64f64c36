"""Multi-host runs: processes over torch.distributed, reads range-sharded.

Counterpart of yaha_tpu/parallel/distributed.py.  Every host runs the
same command with its own --host-id:

  * `initialize` joins the processes in a gloo group (the counterpart of
    jax.distributed, which the reference uses between hosts and only
    there; within a host the grid of parallel/mesh.py is one process);
  * the query file is range-sharded per host (`host_read_range`), each
    host writing its SAM records to its own part file (`part_file_name`);
  * after a barrier, host 0 concatenates the parts in host order under the
    merged file's header (`merge_part_files`), so the output is the
    single-host run's.

The barrier is the only traffic between hosts: an all_reduce of a few
bytes on the host (the reference's psum of ones), for which gloo serves;
no device memory crosses.
"""
from __future__ import annotations

import torch.distributed as tdist


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """Join the gloo group at tcp://coordinator_address (host:port, host
    0's address); a no-op for a single process."""
    if num_processes is None or num_processes <= 1:
        return
    if not coordinator_address:
        raise ValueError("initialize: %d processes need a coordinator "
                         "address (host:port)" % num_processes)
    tdist.init_process_group("gloo",
                             init_method="tcp://" + coordinator_address,
                             world_size=num_processes,
                             rank=int(process_id or 0))


def rank() -> int:
    """This process's rank (0 without a group)."""
    return tdist.get_rank() if tdist.is_initialized() else 0


def world_size() -> int:
    """The group's size (1 without a group)."""
    return tdist.get_world_size() if tdist.is_initialized() else 1


def host_read_range(n_reads: int, process_index: int | None = None,
                    process_count: int | None = None) -> tuple[int, int]:
    """[lo, hi) slice of the query file owned by this host."""
    pi = rank() if process_index is None else process_index
    pc = world_size() if process_count is None else process_count
    per = (n_reads + pc - 1) // pc
    lo = min(pi * per, n_reads)
    return lo, min(lo + per, n_reads)


def part_file_name(ofile_name: str, process_index: int | None = None) -> str:
    pi = rank() if process_index is None else process_index
    return "%s.part%05d" % (ofile_name, pi)


def merge_part_files(ofile_name: str, process_count: int,
                     header: str) -> None:
    """Host 0's concatenation of the per-host SAM parts in host order."""
    with open(ofile_name, "w") as out:
        out.write(header)
        for pi in range(process_count):
            with open(part_file_name(ofile_name, pi)) as f:
                out.write(f.read())


def barrier() -> int:
    """Wait for every process: an all_reduce of a CPU ones tensor (the
    reference's psum of ones).  Returns the sum, the process count."""
    import torch
    ones = torch.ones(1, dtype=torch.int64)
    if tdist.is_initialized():
        tdist.all_reduce(ones)
    return int(ones.item())


def shutdown() -> None:
    """Leave the group (at the end of a run)."""
    if tdist.is_initialized():
        tdist.destroy_process_group()
