"""A model of the port's native data-feed shuffle
(``tony_tpu_torch/io/native/datafeed.cc``), for the CPU parity tests:
``std::mt19937_64`` and libstdc++'s ``uniform_int_distribution`` (Lemire's
method for a 64-bit generator) drawing from a full window over a split's
records in file order."""

_M64 = (1 << 64) - 1


class MT19937_64:
    """``std::mt19937_64``, seeded with one value."""

    def __init__(self, seed):
        self.mt = [seed & _M64]
        for i in range(1, 312):
            prev = self.mt[-1]
            self.mt.append((6364136223846793005 * (prev ^ (prev >> 62))
                            + i) & _M64)
        self.i = 312

    def __call__(self):
        mt = self.mt
        if self.i >= 312:
            for k in range(312):
                x = ((mt[k] & 0xFFFFFFFF80000000)
                     | (mt[(k + 1) % 312] & 0x7FFFFFFF))
                xa = x >> 1
                if x & 1:
                    xa ^= 0xB5026F5AA96619E9
                mt[k] = mt[(k + 156) % 312] ^ xa
            self.i = 0
        y = mt[self.i]
        self.i += 1
        y ^= (y >> 29) & 0x5555555555555555
        y ^= (y << 17) & 0x71D67FFFEDA60000
        y ^= (y << 37) & 0xFFF7EEE000000000
        y ^= y >> 43
        return y & _M64


def _uniform_below(gen, n):
    """libstdc++'s ``uniform_int_distribution<size_t>(0, n - 1)`` over a
    64-bit generator: Lemire's nearly divisionless method."""
    prod = gen() * n
    low = prod & _M64
    if low < n:
        threshold = ((1 << 64) - n) % n
        while low < threshold:
            prod = gen() * n
            low = prod & _M64
    return prod >> 64


def model_shuffle(records, capacity, seed):
    """The stream of a full-window shuffle over ``records`` (file order):
    fill the window, draw a slot, swap-remove it, refill."""
    gen, it, pool, out, done = MT19937_64(seed), iter(records), [], [], False
    while True:
        while len(pool) < capacity and not done:
            try:
                pool.append(next(it))
            except StopIteration:
                done = True
        if not pool:
            return out
        slot = _uniform_below(gen, len(pool)) if len(pool) > 1 else 0
        pool[slot], pool[-1] = pool[-1], pool[slot]
        out.append(pool.pop())
