"""Host-side KV page allocator with per-owner refcounts.

The device side never frees anything — pools are fixed buffers and a
page is "freed" by the host dropping its id back into the free list.
Correctness therefore hangs on this allocator's bookkeeping, which is
why it refcounts: the no-leak invariant the scheduler tests pin is
``pages_in_use == 0`` (and every refcount gone) after all requests
finish or are cancelled.

Page 0 is reserved at construction as the *write sink*: device-side
appends from inactive slots / padded chunk tails are clamped onto it
(see ``models.common._page_rows``), so it is never handed to a stream
and its contents are never read.
"""
from __future__ import annotations


class PagePoolExhausted(RuntimeError):
    """The pool cannot satisfy a reservation or allocation.

    Typed so the scheduler can catch exactly this condition (and
    preempt a victim stream under overcommit) without masking real
    bookkeeping bugs behind a bare ``RuntimeError``.
    """


class PagePool:
    """Free-list allocator over ``num_pages`` KV pages.

    Pages are owned by request uids; :meth:`free_owner` releases
    everything a request holds, so cancel/finish paths cannot
    half-release. ``reserve`` implements admission control: under
    ``overcommit='none'`` a request is only admitted when its
    worst-case page need (prompt + max_new tokens) is covered, so
    decode can never hit pool exhaustion mid-stream. Under overcommit
    the engine reserves less up front and grows the reservation
    just-in-time via :meth:`add_reservation`; a ``False`` return there
    is the signal that triggers preemption.
    """

    def __init__(self, num_pages: int):
        if num_pages < 2:
            raise ValueError("need at least 2 pages (page 0 is the write sink)")
        self.num_pages = num_pages
        self._free = list(range(num_pages - 1, 0, -1))  # pop() -> lowest id
        self._owner_pages: dict[object, list[int]] = {}
        self._reserved: dict[object, int] = {}

    # -- capacity ---------------------------------------------------------

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return sum(len(v) for v in self._owner_pages.values())

    @property
    def reserved_pages(self) -> int:
        return sum(self._reserved.values())

    def available(self) -> int:
        """Pages neither allocated nor promised to an admitted request."""
        return self.free_pages - self.reserved_pages

    # -- reservations (admission control) ---------------------------------

    def can_reserve(self, n: int) -> bool:
        return self.available() >= n

    def reserve(self, owner, n: int) -> None:
        if owner in self._reserved or owner in self._owner_pages:
            raise ValueError(f"owner {owner!r} already admitted")
        if not self.can_reserve(n):
            raise PagePoolExhausted(
                f"page pool exhausted: want {n}, available {self.available()}")
        self._reserved[owner] = n
        self._owner_pages[owner] = []

    def add_reservation(self, owner, n: int = 1) -> bool:
        """Grow an admitted owner's reservation by ``n`` pages.

        Returns False (without changing anything) when the pool has no
        unpromised pages left — the caller decides what gives way.
        """
        if owner not in self._owner_pages:
            raise ValueError(f"owner {owner!r} not admitted")
        if self.available() < n:
            return False
        self._reserved[owner] = self._reserved.get(owner, 0) + n
        return True

    def reserved_for(self, owner) -> int:
        """Unspent reservation (pages promised but not yet allocated)."""
        return self._reserved.get(owner, 0)

    # -- allocation --------------------------------------------------------

    def alloc(self, owner) -> int:
        """Take one page against ``owner``'s reservation."""
        if self._reserved.get(owner, 0) <= 0:
            raise PagePoolExhausted(
                f"owner {owner!r} has no reservation left")
        if not self._free:
            raise PagePoolExhausted(
                "free list empty with reservations outstanding — "
                "reservation accounting is corrupt")
        page = self._free.pop()
        self._reserved[owner] -= 1
        self._owner_pages[owner].append(page)
        return page

    def owned(self, owner) -> list[int]:
        return list(self._owner_pages.get(owner, ()))

    def refcount(self, owner) -> int:
        return len(self._owner_pages.get(owner, ()))

    def free_owner(self, owner) -> list[int]:
        """Release every page and any unspent reservation of ``owner``.

        Returns the freed page ids (the engine zeroes their block-table
        entries). Idempotent: freeing an unknown owner is a no-op.
        """
        pages = self._owner_pages.pop(owner, [])
        self._reserved.pop(owner, None)
        for p in pages:
            self._free.append(p)
        return pages

    def check_no_leaks(self) -> None:
        """Assert the pool is back to its pristine state."""
        if self._owner_pages or self._reserved:
            raise AssertionError(
                f"leaked pages: owners={ {k: len(v) for k, v in self._owner_pages.items()} } "
                f"reservations={dict(self._reserved)}")
        if len(self._free) != self.num_pages - 1:
            raise AssertionError(
                f"free list has {len(self._free)} pages, expected {self.num_pages - 1}")
