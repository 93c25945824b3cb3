"""The port's copy of ``ceph_tpu.journal``."""

from ceph_tpu_torch.journal.journaler import Journaler, JournalEntry

__all__ = ["Journaler", "JournalEntry"]
