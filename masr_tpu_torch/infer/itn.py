"""Chinese inverse text normalization fallback (a copy of
masr_tpu/infer/itn.py).

The reference lazily imports WeTextProcessing's InverseNormalizer
(predict.py:356-362). When that package is absent, this native
implementation covers the common ITN categories for ASR output:
cardinal/decimal numbers, percentages (百分之X → X%), fractions
(X分之Y → Y/X), clock times (X点X分/半 → H:MM), dates (X年X月X日),
money amounts (X元/块), and ordinals (第X). Rules run most-specific
first and are intentionally conservative: anything unparseable is left
untouched.
"""
import re

_DIGITS = {"零": 0, "一": 1, "二": 2, "两": 2, "三": 3, "四": 4, "五": 5,
           "六": 6, "七": 7, "八": 8, "九": 9}
_UNITS = {"十": 10, "百": 100, "千": 1000}
_BIG_UNITS = {"万": 10 ** 4, "亿": 10 ** 8}
_NUM_CHARS = "".join(_DIGITS) + "".join(_UNITS) + "".join(_BIG_UNITS) + "点"


def _parse_section(s):
    """Parse a section without 万/亿 units → int."""
    total, current = 0, 0
    for ch in s:
        if ch in _DIGITS:
            current = current * 10 + _DIGITS[ch] if current >= 10 else _DIGITS[ch]
        elif ch in _UNITS:
            total += (current if current else 1) * _UNITS[ch]
            current = 0
    return total + current


def _parse_chinese_number(s):
    if not s or s == "零":
        return 0 if s else None
    # decimal part
    if "点" in s:
        left, _, right = s.partition("点")
        ip = _parse_chinese_number(left)
        if ip is None:
            return None
        frac = "".join(str(_DIGITS.get(c, "")) for c in right)
        if not frac or any(c not in _DIGITS for c in right):
            return None
        return float(f"{ip}.{frac}")
    total = 0
    rest = s
    for ch, mult in sorted(_BIG_UNITS.items(), key=lambda kv: -kv[1]):
        if ch in rest:
            left, _, rest = rest.partition(ch)
            total += (_parse_section(left) if left else 1) * mult
    return total + _parse_section(rest)


_NUM = f"[{_NUM_CHARS}]+"
_PLAIN = "".join(_DIGITS) + "".join(_UNITS) + "".join(_BIG_UNITS)


def _num(s):
    """Chinese numeral → int/float, or None."""
    return _parse_chinese_number(s)


def _digits_only(s):
    """Digit-by-digit reading (years, phone numbers): 二零二三 → '2023'."""
    if s and all(c in _DIGITS for c in s):
        return "".join(str(_DIGITS[c]) for c in s)
    return None


class SimpleInverseNormalizer(object):
    _number = re.compile(f"[{_NUM_CHARS}]{{2,}}|[{''.join(_DIGITS)}]")
    _percent = re.compile(f"百分之([{_PLAIN}点]+)")
    _fraction = re.compile(f"([{_PLAIN}]+)分之([{_PLAIN}]+)")
    _time = re.compile(f"([{_PLAIN}]+)点(?:([{_PLAIN}]+)分|(半)|(整))")
    _date = re.compile(
        f"([{_PLAIN}]+)年(?:([{_PLAIN}]+)月)?(?:([{_PLAIN}]+)[日号])?")
    _money = re.compile(f"([{_PLAIN}点]+)(元|块钱|块)")
    _ordinal = re.compile(f"第([{_PLAIN}]+)")

    def normalize(self, text):
        text = self._percent.sub(self._sub_percent, text)
        text = self._fraction.sub(self._sub_fraction, text)
        text = self._time.sub(self._sub_time, text)
        text = self._date.sub(self._sub_date, text)
        text = self._money.sub(self._sub_money, text)
        text = self._ordinal.sub(self._sub_ordinal, text)
        return self._number.sub(self._sub_number, text)

    # ------------------------------------------------------------------ #
    @staticmethod
    def _sub_percent(m):
        val = _num(m.group(1))
        return f"{val}%" if val is not None else m.group(0)

    @staticmethod
    def _sub_fraction(m):
        den, num = _num(m.group(1)), _num(m.group(2))
        if den is None or num is None:
            return m.group(0)
        return f"{num}/{den}"

    @staticmethod
    def _sub_time(m):
        hour = _num(m.group(1))
        if hour is None or not float(hour).is_integer() or hour > 24:
            return m.group(0)
        hour = int(hour)
        if m.group(3):  # 半
            return f"{hour}:30"
        if m.group(4):  # 整
            return f"{hour}:00"
        minute = _num(m.group(2))
        if minute is None or not float(minute).is_integer() or minute > 59:
            return m.group(0)
        return f"{hour}:{int(minute):02d}"

    @staticmethod
    def _sub_date(m):
        year = _digits_only(m.group(1))
        if year is None:
            y = _num(m.group(1))
            if y is None or not float(y).is_integer():
                return m.group(0)
            year = str(int(y))
        out = f"{year}年"
        for part, suffix in ((m.group(2), "月"), (m.group(3), "日")):
            if part:
                v = _num(part)
                if v is None or not float(v).is_integer():
                    return m.group(0)
                out += f"{int(v)}{suffix}"
        return out

    @staticmethod
    def _sub_money(m):
        val = _num(m.group(1))
        if val is None:
            return m.group(0)
        return f"{val}{m.group(2)}"

    @staticmethod
    def _sub_ordinal(m):
        val = _num(m.group(1))
        if val is None or not float(val).is_integer():
            return m.group(0)
        return f"第{int(val)}"

    @staticmethod
    def _sub_number(m):
        s = m.group(0)
        # pure sequences of digits read one-by-one ("一二三" → 123)
        if all(c in _DIGITS for c in s) and len(s) > 1:
            return "".join(str(_DIGITS[c]) for c in s)
        if len(s) == 1:
            return s  # leave single digits as characters
        val = _parse_chinese_number(s)
        if val is None:
            return s
        return str(val)
